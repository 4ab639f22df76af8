"""Decoder configuration.

Capability parity with ``LatticeFasterDecoderConfig``
(ref: src/my-decoder/lattice-faster-decoder-conf.h:8-68, defaults :35-44).
Device-search knobs (beam_width, arc_lanes, eps_iters, ...) control the
dense fixed-shape search arrays; they have no reference equivalent because
the reference's HashList is dynamically sized.
"""

from __future__ import annotations

from dataclasses import dataclass

from asr_decoder_tpu.utils.config import ConfigOptions, flag


@dataclass
class DecoderConfig:
    # reference-equivalent knobs
    beam: float = flag(16.0, "Decoding beam (cost margin over best token)")
    max_active: int = flag(7000, "Upper bound on active tokens per frame")
    min_active: int = flag(200, "Lower bound on active tokens per frame")
    lattice_beam: float = flag(10.0, "Lattice pruning beam")
    # prune_interval (ref default 25) is deliberately absent: the reference
    # prunes periodically to bound *memory* of its token/link heap
    # (PruneActiveTokens, online-decoder-base-inl.h:439); the device search
    # is fixed-shape [B,K] so memory never grows — extra-cost pruning happens
    # once, at host lattice reconstruction (decoder/raw_lattice.py), with
    # identical lattice_beam semantics.
    acoustic_scale: float = flag(1.0, "Scale on acoustic log-likelihoods")
    # device-search knobs
    beam_width: int = flag(
        1024, "Device token-array width K (top-K per frame); the dense "
              "analogue of max_active")
    arc_lanes: int = flag(
        16, "Padded emitting/eps arcs per token lane; states with higher "
            "out-degree are split at graph load")
    eps_iters: int = flag(
        0, "Epsilon-closure sweeps per frame (sweeps mode); 0 = use the "
           "graph's exact eps depth computed at load")
    eps_mode: str = flag(
        "auto", "Device epsilon handling: 'closure' = one precomputed "
                "closure-table relaxation per frame, 'sweeps' = eps-depth "
                "bounded relaxation sweeps, 'auto' = closure unless the "
                "graph's closure fan-out exceeds closure_lanes_max")
    closure_lanes_max: int = flag(
        32, "auto eps_mode falls back to sweeps when any state has more "
            "epsilon-closure entries than this")
    log_snapshots: bool = flag(
        True, "Log per-frame token snapshots (needed for lattices; turn "
              "off for best-path-only throughput serving)")
    relax_impl: str = flag(
        "auto", "Per-frame relax kernel: 'sort' = full-width 3-key sort "
                "(v2), 'topk' = top-k-first with narrow dedup sort over "
                "packed state records (v3; closure mode only), "
                "'auto' = topk when the graph supports it")
    topk_overfetch: int = flag(
        2, "relax_impl=topk: keep K*this candidates before destination "
           "dedup (duplicate-dense frames keep more distinct states; 1 = "
           "cheapest, larger = closer to exact max_active semantics)")
    lm_lanes: int = flag(
        1024, "BigLM in-search: word candidates are compacted to this many "
              "lanes before the per-candidate LM probe; >= K*arc_lanes "
              "disables compaction (exact)")

    def register(self, opts: ConfigOptions, prefix: str = "") -> None:
        opts.register_dataclass(self, prefix)

    def check(self) -> None:
        assert self.beam > 0 and self.beam_width > 0 and self.arc_lanes > 1
        assert self.max_active >= self.min_active
