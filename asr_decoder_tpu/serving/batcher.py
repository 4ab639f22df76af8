"""Batched multi-stream decoding: channel arena + dynamic batcher.

Capability parity with the reference GPU batched pipeline — corr-id-keyed
chunk push into a dynamic batcher that packs many streaming channels into one
device dispatch (ref: src/gpu-asr/v1-gpu-kaldi-worker-pool.h:20-202 wrapping
Kaldi BatchedThreadedNnet3CudaOnlinePipeline + CudaOnlinePipelineDynamicBatcher,
conf: --max-batch-size=300 --num-channels=900, src/gpu-asr/conf/config.txt).
Channel slots have an explicit acquire/release lifecycle, fixing the
reference's corr-id reuse race (ref: gpu-asr/README "to do").

Device-first design: all per-channel device state lives in fixed-shape
arenas —
beam state i32/f32[B,K], LSTM carries f32[B,H] — and one jitted step advances
every channel at once; idle channels ride along fully masked (frame_mask
False ⇒ beam state provably unchanged; LSTM carries are where-merged back).
So N streams cost one XLA dispatch per tick regardless of N ≤ B, and the
program never recompiles as channels come and go.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from asr_decoder_tpu.ops.beamsearch import BeamState, FrameLog
from asr_decoder_tpu.serving.session import FeatureBuffer, OnlineDecoderInfo
from asr_decoder_tpu.models.layers import init_layer_state
from asr_decoder_tpu.models.nnet import am_forward


@dataclass
class _Channel:
    """Host-side per-channel streaming state (the corr-id keyed stream,
    ref: v1-gpu-kaldi-worker-pool.h:74-190)."""
    front: object                  # StreamingFrontend
    featbuf: FeatureBuffer
    skip_phase: int = 0
    pending: list[np.ndarray] = field(default_factory=list)
    pending_frames: int = 0
    eos: bool = False
    drained: bool = False          # eos fully scored
    chunk_logs: list[FrameLog] = field(default_factory=list)
    loglikes: list[np.ndarray] = field(default_factory=list)
    frames_decoded: int = 0
    vad: object = None             # per-channel EnergyVadStream (endpointing)
    trailing_sil: int = 0


@dataclass
class ChannelSnapshot:
    """Immutable capture of one channel's result state (see the results
    section below): frame-log arrays and beam arrays are never mutated in
    place, so heavy result building can run off the device thread."""
    beam: object
    chunk_logs: list
    loglikes: list
    frames_decoded: int


def _tree_where(mask_b, new, old):
    """Per-leaf jnp.where over batch-leading pytrees, mask bool[B]."""
    def sel(n, o):
        m = mask_b.reshape((-1,) + (1,) * (n.ndim - 1))
        return jnp.where(m, n, o)
    return jax.tree_util.tree_map(sel, new, old)


class BatchedStreamingDecoder:
    """Up to ``num_channels`` concurrent streams through one device program.

    push(cid, pcm, eos) is host-side frontend work; step() performs exactly
    one batched AM forward + search advance over every channel with ready
    frames (the DynamicBatcher::Push/compute cycle).
    """

    def __init__(self, info: OnlineDecoderInfo, num_channels: int,
                 mesh=None):
        """``mesh``: optional jax.sharding.Mesh — dp-shards the channel
        arenas over the mesh's ``dp`` axis (graph replicated), so one
        arena serves streams across all chips of a slice (BASELINE
        config 5; num_channels must divide by the dp size)."""
        self.info = info
        self.B = num_channels
        self.mesh = mesh
        self._channels: list[_Channel | None] = [None] * num_channels
        self._free = list(range(num_channels))[::-1]
        if mesh is not None:
            from asr_decoder_tpu.parallel.decode import shard_search
            assert num_channels % mesh.shape["dp"] == 0, \
                (num_channels, dict(mesh.shape))
            shard_search(mesh, info.search)
        # device arenas
        beam, init_log = info.search.init_state(num_channels)
        if mesh is not None:
            from asr_decoder_tpu.parallel.decode import shard_beam_state
            beam = shard_beam_state(mesh, beam)
        self._beam = beam
        # init rows are identical across the arena: keep row 0 as template.
        # Generic over the variant's init-log pytree: leaves are
        # [stages, B, K] (ndim 3 → slice axis 1) or [B, ...] (slice axis 0)
        self._init_log_tree = jax.tree_util.tree_map(
            lambda a: np.asarray(a[:, :1] if a.ndim == 3 else a[:1]),
            init_log)
        self._beam_init_row = jax.tree_util.tree_map(
            lambda a: a[:1], beam)
        self._am_state = [init_layer_state(l, num_channels)
                          for l in info.am_layers]
        if mesh is not None:
            from asr_decoder_tpu.parallel.mesh import data_sharding
            self._am_state = [
                {k: jax.device_put(v, data_sharding(mesh, v.ndim))
                 for k, v in st.items()} if st else st
                for st in self._am_state]
        self._am_zero_row = [init_layer_state(l, 1) for l in info.am_layers]
        C = info.config.chunk_frames
        D = info.am_layers[0].input_dim if info.am_layers else 0
        self._feat_dim = D
        self._zeros_chunk = np.zeros((C, D), np.float32)
        # deferred device→host log fetch (AM/search ↔ host overlap):
        # (advanced, valid, device log pytree, device loglikes)
        self._pending: tuple | None = None

    # -- deferred log materialization (dispatch overlap) -------------------
    def _flush_logs(self) -> None:
        """Materialize the previous tick's per-channel logs.  step() defers
        this so the host can pack + dispatch tick t+1 while tick t still
        executes on device and its logs stream back — the arena-level
        AM/search overlap (JAX async dispatch; the reference's analogue is
        the gpu-asr pipeline's decoupled compute/callback threads,
        ref: src/gpu-asr/v1-gpu-kaldi-worker-pool.h:74-190)."""
        if self._pending is None:
            return
        advanced, valid, log, loglikes = self._pending
        self._pending = None
        log_np = jax.tree_util.tree_map(np.asarray, log)
        ll_np = np.asarray(loglikes)
        for cid in advanced:
            ch = self._channels[cid]
            if ch is None:          # released mid-flight
                continue
            v = int(valid[cid])
            ch.chunk_logs.append(jax.tree_util.tree_map(
                lambda a, v=v, c=cid: (a[:v, :, c:c + 1] if a.ndim >= 4
                                       else a[:v, c:c + 1]), log_np))
            ch.loglikes.append(ll_np[cid, :v])
            ch.frames_decoded += v

    # -- channel lifecycle (explicit slots; no corr-id collisions) ---------
    def acquire(self) -> int:
        if not self._free:
            raise RuntimeError("no free channels")
        cid = self._free.pop()
        info = self.info
        from asr_decoder_tpu.vad.energy import EnergyVadStream
        self._channels[cid] = _Channel(
            front=info.make_frontend(batch=1),
            featbuf=FeatureBuffer(info.left, info.right, info.splice_offsets),
            vad=(EnergyVadStream(info.vad_config, batch=1)
                 if info.config.use_energy_vad else None))
        self._reset_rows([cid])
        return cid

    def release(self, cid: int) -> None:
        assert self._channels[cid] is not None, "double release"
        self._channels[cid] = None
        self._free.append(cid)

    def _reset_rows(self, cids: list[int]) -> None:
        """Reset beam + AM arena rows for the given channels."""
        idx = jnp.asarray(np.asarray(cids, np.int32))
        self._beam = jax.tree_util.tree_map(
            lambda a, r: a.at[idx].set(
                jnp.broadcast_to(r, (len(cids),) + r.shape[1:])),
            self._beam, self._beam_init_row)
        self._am_state = [
            {k: v.at[idx].set(jnp.broadcast_to(z[k],
                                               (len(cids),) + z[k].shape[1:]))
             for k, v in st.items()} if st else st
            for st, z in zip(self._am_state, self._am_zero_row)]

    def init_decoding(self, cid: int) -> None:
        """Restart the channel's search only, keeping feature/AM streaming
        state — the mid-stream endpoint restart (ref InitDecoding
        (frame_offset), kaldi-online-nnet3-my-decoder.h:301-324)."""
        self._flush_logs()
        ch = self._channels[cid]
        assert ch is not None
        idx = jnp.asarray(np.asarray([cid], np.int32))
        self._beam = jax.tree_util.tree_map(
            lambda a, r: a.at[idx].set(
                jnp.broadcast_to(r, (1,) + r.shape[1:])),
            self._beam, self._beam_init_row)
        ch.chunk_logs = []
        ch.loglikes = []
        ch.frames_decoded = 0

    def endpoint_detected(self, cid: int) -> bool:
        """ref EndpointDetected (kaldi-online-nnet3-my-decoder.h:344);
        needs use_energy_vad."""
        self._flush_logs()
        cfg = self.info.config
        ch = self._channels[cid]
        return (ch is not None
                and ch.frames_decoded >= cfg.min_endpoint_frames
                and ch.trailing_sil >= cfg.endpoint_sil_frames)

    # -- streaming input (host frontend, ref DynamicBatcher::Push) ---------
    def push(self, cid: int, pcm: np.ndarray, eos: bool = False) -> None:
        ch = self._channels[cid]
        assert ch is not None and not ch.eos
        info = self.info
        pcm = np.asarray(pcm, np.float32).reshape(1, -1)
        if ch.vad is not None and pcm.shape[1]:
            decisions = np.asarray(ch.vad.accept(pcm, end=eos))[0]
            sil_run = 0
            for d in decisions[::-1]:
                if d:
                    break
                sil_run += 1
            ch.trailing_sil = (ch.trailing_sil + sil_run
                               if sil_run == len(decisions) else sil_run)
        feats = ch.front.accept(pcm, end=eos)[0]
        spliced = ch.featbuf.accept(feats, end=eos)
        # skip_copy subsamples + score-copies inside am_forward (chunks are
        # phase-aligned: chunk_frames % (skip+1) == 0, asserted at info
        # build); plain skip drops frames here — mirrors session.py exactly
        skip = info.am_config.skip
        if skip and spliced.shape[0] and not info.am_config.skip_copy:
            sel = (np.arange(spliced.shape[0]) + ch.skip_phase) \
                % (skip + 1) == 0
            ch.skip_phase = (ch.skip_phase + spliced.shape[0]) % (skip + 1)
            spliced = spliced[sel]
        if spliced.shape[0]:
            ch.pending.append(spliced)
            ch.pending_frames += spliced.shape[0]
        if eos:
            ch.eos = True
            if ch.pending_frames == 0:
                ch.drained = True

    def ready(self, cid: int) -> bool:
        """Channel has a full chunk (or an EOS flush) waiting."""
        ch = self._channels[cid]
        if ch is None or ch.drained:
            return False
        C = self.info.config.chunk_frames
        return ch.pending_frames >= C or (ch.eos and ch.pending_frames > 0)

    def pending_work(self) -> bool:
        return any(self.ready(c) for c in range(self.B)
                   if self._channels[c] is not None)

    # -- the batched device step -------------------------------------------
    def step(self) -> list[int]:
        """One batched AM+search dispatch over every ready channel.
        Returns the channel ids that advanced."""
        info = self.info
        C = info.config.chunk_frames
        feats = np.zeros((self.B, C, self._feat_dim), np.float32)
        valid = np.zeros(self.B, np.int32)
        advanced: list[int] = []
        for cid in range(self.B):
            if not self.ready(cid):
                continue
            ch = self._channels[cid]
            buf = np.concatenate(ch.pending, axis=0)
            take, rest = buf[:C], buf[C:]
            ch.pending = [rest] if rest.shape[0] else []
            ch.pending_frames = rest.shape[0]
            v = take.shape[0]
            if v < C:
                take = np.concatenate(
                    [take, np.repeat(take[-1:], C - v, axis=0)], axis=0)
            feats[cid] = take
            valid[cid] = v
            advanced.append(cid)
            if ch.eos and ch.pending_frames == 0:
                ch.drained = True
        if not advanced:
            return []
        ac = info.am_config
        feats_dev = jnp.asarray(feats)
        if self.mesh is not None:
            from asr_decoder_tpu.parallel.mesh import shard_batch
            feats_dev = shard_batch(self.mesh, feats_dev)
        loglikes, new_am = am_forward(
            info.am_layers, feats_dev, self._am_state,
            do_softmax=ac.do_softmax, do_log=ac.do_log,
            sub_prior=ac.sub_prior, block_pdf_pdfid=ac.block_pdf_pdfid,
            block_scale=ac.block_scale, skip_block=ac.skip_block,
            skip=ac.skip if ac.skip_copy else 0, skip_copy=ac.skip_copy)
        active = jnp.asarray(valid > 0)
        # idle channels keep their LSTM carries bit-exactly
        self._am_state = [
            _tree_where(active, n, o) if o else o
            for n, o in zip(new_am, self._am_state)]
        mask = jnp.asarray(np.arange(C)[None, :] < valid[:, None])
        if ac.skip_blank_frames and ac.block_pdf_pdfid >= 0:
            # CTC blank-skip (ref SkipBlockFrame, nnet-nnet.h:265-275)
            from asr_decoder_tpu.models.nnet import blank_frame_mask
            mask = mask & ~blank_frame_mask(loglikes, ac.block_pdf_pdfid,
                                            ac.acoustic_scale)
        self._beam, log = info.search.advance(self._beam, loglikes, mask)
        # materialize the PREVIOUS tick's logs now that this tick is
        # dispatched (its transfer overlaps this tick's device compute)
        self._flush_logs()
        # DON'T materialize the logs yet: stash the device arrays and
        # return — the fetch happens lazily (next step() after t+1's
        # dispatch, or on first result read), overlapping device compute
        # with the device→host log transfer.  Log splitting itself is
        # generic over the decoder variant's log pytree: every leaf has a
        # leading T axis, then either (stages, B, ...) for ndim ≥ 4 or
        # (B, ...) otherwise (covers hclg FrameLog, BigLmFrameLog incl.
        # its [T, B] overflow leaf, and the CLG plain-tuple log)
        self._pending = (advanced, valid, log, loglikes)
        return advanced

    def drain(self) -> None:
        """Run steps until no channel has ready work."""
        while self.pending_work():
            self.step()
        self._flush_logs()

    # -- results -------------------------------------------------------------
    #
    # Result building is split in two so a server can run the EXPENSIVE part
    # (traceback / lattice / determinize / n-best — pure host compute over
    # immutable arrays) on a separate thread from the device loop (the
    # reference likewise isolates result/rescore work from decode threads,
    # ref: src/post-processing-service/):
    #   * ``snapshot(cid)`` — O(1) capture of the channel's result state;
    #     MUST run serialized with ``step()`` (same single-writer thread);
    #   * ``*_from(snap)`` — heavy builders over the snapshot; safe to run
    #     concurrently with further ``step()`` calls because every captured
    #     object (frame-log arrays, beam arrays) is immutable and ``step``
    #     only rebinds/appends.
    def _channel_beam(self, cid: int):
        return jax.tree_util.tree_map(lambda a: a[cid:cid + 1], self._beam)

    def snapshot(self, cid: int):
        """Immutable result-state snapshot of a channel (cheap)."""
        self._flush_logs()
        ch = self._channels[cid]
        return ChannelSnapshot(
            beam=self._channel_beam(cid),
            chunk_logs=list(ch.chunk_logs),
            loglikes=list(ch.loglikes),
            frames_decoded=ch.frames_decoded)

    def _merged_logs_from(self, snap):
        if not snap.chunk_logs:
            return None
        return jax.tree_util.tree_map(
            lambda *xs: np.concatenate(xs, axis=0), *snap.chunk_logs)

    def _init_log(self):
        return self._init_log_tree

    def get_best_path_from(self, snap) -> dict:
        if not snap.chunk_logs:
            return dict(arc_ids=[], cost=0.0, words=[], ilabels=[],
                        reached_final=False)
        if self.info.config.graph_type == "clg":
            return self.info.search.traceback(
                snap.beam, self._init_log(), snap.chunk_logs)[0]
        return self.info.search.traceback(
            snap.beam, self._init_log(), snap.chunk_logs,
            self.info.fst)[0]

    def get_best_path(self, cid: int) -> dict:
        return self.get_best_path_from(self.snapshot(cid))

    def get_best_path_txt(self, cid: int) -> str:
        res = self.get_best_path(cid)
        return " ".join(self.info.words.words(res.get("words", [])))

    def get_word_alignment_from(self, snap, frame_offset: int = 0
                                ) -> list[tuple[str, float, float]]:
        """AlignTime payload for the channel's best path (ref AlignTime,
        net-data-package.h:210)."""
        from asr_decoder_tpu.align.word_align import (spans_to_align,
                                                      word_spans)
        fst = self.info.fst
        if fst is None:
            raise RuntimeError(
                "word alignment needs an arc-labeled StdFst graph "
                "(hclg/biglm-hclg)")
        res = self.get_best_path_from(snap)
        spans = word_spans(res.get("arc_ids", []), fst.arc_ilabel,
                           fst.arc_olabel, frame_offset,
                           anchor=getattr(fst, "olabel_anchor", "start"))
        return spans_to_align(spans, self.info.words,
                              self.info.seconds_per_frame)

    def get_word_alignment(self, cid: int, frame_offset: int = 0):
        return self.get_word_alignment_from(self.snapshot(cid),
                                            frame_offset)

    def get_lattice_from(self, snap, determinize: bool = True):
        from asr_decoder_tpu.fst.determinize import (DeterminizeError,
                                                     determinize_lattice)
        ac = self.info.am_config
        if ac.skip_blank_frames and ac.block_pdf_pdfid >= 0:
            raise RuntimeError(
                "lattice output is unsupported with skip_blank_frames "
                "(CTC blank-skip is a best-path fast path)")
        logs = self._merged_logs_from(snap)
        if logs is None:
            return None
        lls = np.concatenate(snap.loglikes, axis=0)[None]
        mask = np.ones((1, lls.shape[1]), bool)
        if self.info.config.graph_type == "clg":
            lat = self.info.search.get_lattices(
                self._init_log(), logs, lls, frame_mask=mask)[0]
        else:   # hclg / biglm-hclg share the StdFst-keyed signature
            lat = self.info.search.get_lattices(
                self._init_log(), logs, lls, self.info.fst,
                frame_mask=mask)[0]
        if determinize and lat.num_states:
            try:
                lat = determinize_lattice(lat)
            except DeterminizeError:
                pass
        return lat

    def get_lattice(self, cid: int, determinize: bool = True):
        return self.get_lattice_from(self.snapshot(cid), determinize)

    def get_nbest_from(self, snap, n: int) -> list[dict]:
        from asr_decoder_tpu.fst.nbest import nshortest
        lat = self.get_lattice_from(snap, determinize=True)
        if lat is None or not lat.num_states:
            return []
        # native C++ n-shortest when a toolchain exists (exact parity with
        # the Python path, see native/lattice_ops.cc), Python fallback
        from asr_decoder_tpu.fst import native_nbest
        got = native_nbest.nshortest_bytes(lat.to_bytes(), n)
        if got is not None:
            return [dict(words=r["words"],
                         text=" ".join(self.info.words.words(r["words"])),
                         graph_cost=r["graph_cost"], am_cost=r["am_cost"])
                    for r in got]
        out = []
        for p in nshortest(lat, n):
            words = [a.olabel for a in p.arcs if a.olabel != 0]
            out.append(dict(words=words,
                            text=" ".join(self.info.words.words(words)),
                            graph_cost=p.graph_cost, am_cost=p.am_cost))
        return out

    def get_nbest(self, cid: int, n: int) -> list[dict]:
        return self.get_nbest_from(self.snapshot(cid), n)
