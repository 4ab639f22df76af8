"""Streaming decode sessions — the v2 session API.

Capability parity with the reference ``OnlineClgLatticeFastDecoder``
(ref: src/kaldi-nnet3/kaldi-online-nnet3-my-decoder.h:233-344) and the VAD
orchestration of ``V1AsrWorker`` (ref: src/v1-asr/kaldi-v1-asr-online.h:235):
chunked 16-bit PCM in → features → AM posteriors → device beam search →
partial/final text, n-best, lattice; endpoint detection; mid-stream
re-initialisation after a VAD cut (``InitDecoding(frame_offset)``,
ref: kaldi-online-nnet3-my-decoder.h:301-324).

Device-first design: all device work happens in fixed-shape jitted steps —
features and AM run over fixed ``chunk_frames`` windows, the search advances
through ``TpuBeamSearch.advance`` (one ``lax.scan`` dispatch per chunk) — so
every session of a given model shares one compilation, and a server can run
many sessions as rows of one batch (see serving/server.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from asr_decoder_tpu.decoder.config import DecoderConfig
from asr_decoder_tpu.frontend.fbank import CmvnConfig, FbankConfig
from asr_decoder_tpu.fst.determinize import (DeterminizeError,
                                             determinize_lattice)
from asr_decoder_tpu.fst.fst import StdFst
from asr_decoder_tpu.fst.nbest import nshortest
from asr_decoder_tpu.fst.symbol import SymbolTable
from asr_decoder_tpu.models.layers import init_layer_state, layer_forward
from asr_decoder_tpu.models.nnet import AmConfig, Nnet, am_forward
from asr_decoder_tpu.ops.beamsearch import BeamState, FrameLog, TpuBeamSearch
from asr_decoder_tpu.utils.config import ConfigOptions, flag
from asr_decoder_tpu.vad.energy import EnergyVadConfig, EnergyVadStream


@dataclass
class OnlineDecoderConfig:
    """Session flags (ref: OnlineDecoderConf,
    kaldi-online-nnet3-my-decoder.h:22-83)."""
    graph_type: str = flag("hclg", "hclg|clg|biglm-hclg")
    chunk_frames: int = flag(32, "AM/search frames per device dispatch")
    use_energy_vad: bool = flag(False, "Gate frames through energy VAD")
    endpoint_sil_frames: int = flag(
        50, "Trailing silence frames that trigger an endpoint")
    min_endpoint_frames: int = flag(
        30, "Never endpoint before this many decoded frames")
    ctc_blank_shift: bool = flag(
        False, "ilabel→pdf is ilabel-1 (CTC) instead of transition-id→pdf")

    def register(self, opts: ConfigOptions, prefix: str = "") -> None:
        opts.register_dataclass(self, prefix)


class FeatureBuffer:
    """Streaming feature buffer with left/right context padding.

    The ``DnnFeat`` role (ref: src/nnet/nnet-feature-api.h:10-74): pads left
    context by repeating the first frame, holds back ``right`` frames until
    they have full future context (repeat-pads at EOS), and emits each frame
    exactly once — so stateful layers (LSTM) never see a frame twice.
    Splicing happens here (the reference's Splice reads context rows from
    this buffer, ref: nnet-feature-api.cc GetFeats padding).
    """

    def __init__(self, left: int, right: int, offsets: tuple[int, ...] | None):
        self.left = left
        self.right = right
        self.offsets = offsets  # None: no splice layer, emit raw frames
        self.reset()

    def reset(self) -> None:
        self._buf: np.ndarray | None = None   # [t, D] incl. left padding
        self._next = 0                        # next frame index to emit

    def accept(self, feats: np.ndarray, end: bool = False) -> np.ndarray:
        """feats f32[t, D] new frames → spliced frames ready to score."""
        feats = np.asarray(feats, np.float32)
        if self._buf is None:
            if feats.shape[0] == 0:
                return feats.reshape(0, feats.shape[1] if feats.ndim > 1 else 0)
            pad = np.repeat(feats[:1], self.left, axis=0)
            self._buf = np.concatenate([pad, feats], axis=0)
            self._next = self.left
        elif feats.shape[0]:
            self._buf = np.concatenate([self._buf, feats], axis=0)
        if self._buf is None:
            return np.zeros((0, 0), np.float32)
        buf = self._buf
        if end:
            stop = len(buf)
            if stop > self._next and self.right:
                buf = np.concatenate(
                    [buf, np.repeat(buf[-1:], self.right, axis=0)], axis=0)
        else:
            stop = len(buf) - self.right
        if stop <= self._next:
            return np.zeros((0, buf.shape[1]), np.float32)
        rows = np.arange(self._next, stop)
        self._next = stop
        if self.offsets is None:
            return buf[rows]
        idx = rows[:, None] + np.asarray(self.offsets)[None, :]
        idx = np.clip(idx, 0, len(buf) - 1)
        return buf[idx].reshape(len(rows), -1)


class OnlineDecoderInfo:
    """Shared read-only model state, one per server process
    (ref: OnlineDecoderInfo, kaldi-online-nnet3-my-decoder.h:85-231):
    AM, graph, device search engine, symbol table, configs."""

    def __init__(self, nnet: Nnet, fst: StdFst | None, words: SymbolTable,
                 ilabel2pdf: np.ndarray,
                 decoder_config: DecoderConfig | None = None,
                 online_config: OnlineDecoderConfig | None = None,
                 fbank_config: FbankConfig | None = None,
                 am_config: AmConfig | None = None,
                 cmvn_config: CmvnConfig | None = None,
                 vad_config: EnergyVadConfig | None = None,
                 clg_graph=None, difflm=None,
                 pitch_config=None, process_pitch_config=None,
                 delta_config=None):
        """``graph_type`` (OnlineDecoderConfig) picks the decoder variant
        (ref decoder selection hclg|clg|biglm-hclg,
        kaldi-online-nnet3-my-decoder.h:250-284):

          * ``hclg``       — pre-composed graph ``fst`` (full lattice
            support);
          * ``clg``        — on-the-fly CLG⊗HMM composite: pass
            ``clg_graph`` (fst/clg.py ClgFst); best-path output;
          * ``biglm-hclg`` — in-search difference-LM rescoring: pass
            ``fst`` + ``difflm`` (lm/device_lm.py DeviceDiffLm);
            best-path output, lattices via post-pass rescoring.
        """
        from asr_decoder_tpu.fst.device_fst import DeviceFst
        self.nnet = nnet
        self.fst = fst
        self.words = words
        self.config = online_config or OnlineDecoderConfig()
        self.decoder_config = decoder_config or DecoderConfig()
        self.fbank_config = fbank_config or FbankConfig()
        self.am_config = am_config or AmConfig()
        self.cmvn_config = cmvn_config  # None = no live CMVN
        self.vad_config = vad_config or EnergyVadConfig()
        # optional frontend extensions (the DnnPitchFeat / delta stack,
        # ref: src/nnet/nnet-feature-api.h:86-185, pitch/online-feature.h)
        self.pitch_config = pitch_config
        self.process_pitch_config = process_pitch_config
        self.delta_config = delta_config
        if pitch_config is not None:
            from asr_decoder_tpu.frontend.pitch import ProcessPitchConfig
            if self.process_pitch_config is None:
                self.process_pitch_config = ProcessPitchConfig()
        if self.am_config.skip_copy and self.am_config.skip:
            assert self.config.chunk_frames % (self.am_config.skip + 1) == 0, \
                "skip_copy needs chunk_frames divisible by skip+1 (chunks " \
                "must stay phase-aligned)"
        gt = self.config.graph_type
        if gt == "hclg":
            assert fst is not None, "hclg graph type needs fst"
            dev = DeviceFst.build(fst,
                                  arc_lanes=self.decoder_config.arc_lanes)
            self.search = TpuBeamSearch(dev, ilabel2pdf,
                                        self.decoder_config)
        elif gt == "clg":
            from asr_decoder_tpu.ops.beamsearch_clg import TpuClgBeamSearch
            assert clg_graph is not None, "clg graph type needs clg_graph"
            self.search = TpuClgBeamSearch(clg_graph, ilabel2pdf,
                                           self.decoder_config)
        elif gt == "biglm-hclg":
            from asr_decoder_tpu.ops.beamsearch_biglm import \
                TpuBigLmBeamSearch
            assert fst is not None and difflm is not None, \
                "biglm-hclg graph type needs fst + difflm"
            dev = DeviceFst.build(fst,
                                  arc_lanes=self.decoder_config.arc_lanes)
            self.search = TpuBigLmBeamSearch(dev, ilabel2pdf, difflm,
                                             self.decoder_config)
        else:
            raise ValueError(f"unknown graph_type {gt!r}")
        self.ilabel2pdf = np.asarray(ilabel2pdf, np.int64)
        # split a leading splice layer off: the FeatureBuffer applies it
        layers = nnet.layers
        if layers and layers[0].kind == "splice":
            self.splice_offsets = layers[0].meta
            self.am_layers = layers[1:]
        else:
            self.splice_offsets = None
            self.am_layers = layers
        self.left, self.right = nnet.context()

    @property
    def seconds_per_frame(self) -> float:
        """Wall seconds per *scored* frame: the frontend frame shift times
        the subsampling factor when plain ``skip`` drops frames before the
        search (in ``skip_copy`` mode every frame is scored)."""
        spf = self.fbank_config.frame_shift_ms / 1000.0
        if self.am_config.skip and not self.am_config.skip_copy:
            spf *= self.am_config.skip + 1
        return spf

    def make_frontend(self, batch: int = 1):
        """Composed streaming frontend for one session/channel:
        fbank (+CMVN) (‖ pitch) (+ deltas)."""
        from asr_decoder_tpu.frontend.pipeline import StreamingFrontend
        return StreamingFrontend(
            self.fbank_config, batch=batch, pitch_cfg=self.pitch_config,
            ppitch_cfg=self.process_pitch_config,
            delta_cfg=self.delta_config, cmvn_cfg=self.cmvn_config)


@dataclass
class _PendingChunk:
    feats: list[np.ndarray] = field(default_factory=list)
    count: int = 0


class OnlineDecoderSession:
    """One streaming utterance (ref: OnlineClgLatticeFastDecoder session
    methods ProcessData/GetLattice/GetBestPathTxt/GetNbestTxt/
    EndpointDetected, kaldi-online-nnet3-my-decoder.h:330-344)."""

    def __init__(self, info: OnlineDecoderInfo):
        self.info = info
        self._front = info.make_frontend(batch=1)
        self._vad = (EnergyVadStream(info.vad_config, batch=1)
                     if info.config.use_energy_vad else None)
        self.reset()

    # -- lifecycle ---------------------------------------------------------
    def reset(self) -> None:
        """Full per-utterance reset (ref: Reset + ResetRnnBuffer,
        kaldi-online-nnet3-my-decoder.h:296-299, nnet-nnet.h:178-188)."""
        info = self.info
        self._front.reset()
        if self._vad is not None:
            self._vad.reset()
        self._featbuf = FeatureBuffer(info.left, info.right,
                                      info.splice_offsets)
        self._am_state = [init_layer_state(l, 1) for l in info.am_layers]
        self._skip_phase = 0
        self._trailing_sil = 0
        self.init_decoding()

    def init_decoding(self) -> None:
        """Restart the search only, keeping feature/AM streaming state —
        the VAD-cut resumption (ref: InitDecoding(frame_offset),
        kaldi-online-nnet3-my-decoder.h:301-324)."""
        self._beam, self._init_log = self.info.search.init_state(1)
        self._chunk_logs: list[FrameLog] = []
        self._loglikes: list[np.ndarray] = []
        self._pending: list[np.ndarray] = []
        self.num_frames_decoded = 0

    # -- streaming input ---------------------------------------------------
    def process_data(self, pcm: np.ndarray, eos: bool = False) -> None:
        """Push a chunk of 16-bit-scale PCM samples f32/int16[n]
        (ref: ProcessData, kaldi-online-nnet3-my-decoder.h:330)."""
        info = self.info
        pcm = np.asarray(pcm, np.float32).reshape(1, -1)
        if self._vad is not None and pcm.shape[1]:
            decisions = np.asarray(self._vad.accept(pcm, end=eos))[0]
            sil_run = 0
            for d in decisions[::-1]:
                if d:
                    break
                sil_run += 1
            self._trailing_sil = (self._trailing_sil + sil_run
                                  if sil_run == len(decisions) else sil_run)
        feats = self._front.accept(pcm, end=eos)[0]
        spliced = self._featbuf.accept(feats, end=eos)
        # frame subsampling with a persistent phase so chunk boundaries
        # don't change which frames are scored (ref: NnetForwardOptions
        # _skip, nnet-nnet.cc:93-116)
        skip = info.am_config.skip
        if skip and spliced.shape[0] and not info.am_config.skip_copy:
            sel = (np.arange(spliced.shape[0]) + self._skip_phase) \
                % (skip + 1) == 0
            self._skip_phase = (self._skip_phase + spliced.shape[0]) \
                % (skip + 1)
            spliced = spliced[sel]
        if spliced.shape[0]:
            self._pending.append(spliced)
        self._drain(flush=eos)

    def _drain(self, flush: bool) -> None:
        """Score + search pending frames in fixed-size device chunks."""
        info = self.info
        C = info.config.chunk_frames
        n = sum(p.shape[0] for p in self._pending)
        while n >= C or (flush and n > 0):
            buf = np.concatenate(self._pending, axis=0)
            take, rest = buf[:C], buf[C:]
            self._pending = [rest] if rest.shape[0] else []
            n = rest.shape[0]
            valid = take.shape[0]
            if valid < C:  # EOS flush: repeat-pad, mask in the search
                take = np.concatenate(
                    [take, np.repeat(take[-1:], C - valid, axis=0)], axis=0)
            self._advance(take[None], valid)

    def _advance(self, feats: np.ndarray, valid: int) -> None:
        info = self.info
        ac = info.am_config
        # skip_copy mode: subsample + score-copy inside am_forward — each
        # device chunk is phase-aligned because chunk_frames % (skip+1) == 0
        # (checked at session build), matching the reference's _skip
        # score-copy while the search walks every frame (nnet-nnet.cc:93-116)
        loglikes, self._am_state = am_forward(
            info.am_layers, jnp.asarray(feats), self._am_state,
            do_softmax=ac.do_softmax, do_log=ac.do_log,
            sub_prior=ac.sub_prior, block_pdf_pdfid=ac.block_pdf_pdfid,
            block_scale=ac.block_scale, skip_block=ac.skip_block,
            skip=ac.skip if ac.skip_copy else 0, skip_copy=ac.skip_copy)
        C = feats.shape[1]
        mask = jnp.asarray(np.arange(C)[None, :] < valid)
        if ac.skip_blank_frames and ac.block_pdf_pdfid >= 0:
            # CTC blank-skip: blank-dominated frames don't move tokens
            # (ref SkipBlockFrame, nnet-nnet.h:265-275)
            from asr_decoder_tpu.models.nnet import blank_frame_mask
            mask = mask & ~blank_frame_mask(loglikes, ac.block_pdf_pdfid,
                                            ac.acoustic_scale)
        self._beam, log = info.search.advance(self._beam, loglikes, mask)
        # host-copy the chunk log once here: partial-result tracebacks then
        # walk pure host memory (no per-call device transfers), and HBM
        # doesn't accumulate per-frame logs over long streams
        self._chunk_logs.append(jax.tree.map(np.asarray, log))
        self._loglikes.append(np.asarray(loglikes)[0, :valid])
        self.num_frames_decoded += valid

    # -- results -----------------------------------------------------------
    def _merged_logs(self):
        """Concatenate per-chunk frame logs along the T axis — works for
        every decoder variant's log pytree (leading axis is frames)."""
        if not self._chunk_logs:
            return None
        first = self._chunk_logs[0]
        fields = [np.concatenate([np.asarray(l[i]) for l in
                                  self._chunk_logs], axis=0)
                  for i in range(len(first))]
        return type(first)(*fields) if hasattr(first, "_fields") \
            else tuple(fields)

    def get_best_path(self) -> dict:
        """Best path so far (partial before EOS) — words, ilabels, cost
        (ref: GetBestPath/GetBestPathTxt).  Walks the per-chunk logs
        directly (O(T) per call, no concatenation — the reference's
        TraceBackBestPath cost shape)."""
        if not self._chunk_logs:
            return dict(arc_ids=[], cost=0.0, words=[], ilabels=[],
                        reached_final=False)
        if self.info.config.graph_type == "clg":
            return self.info.search.traceback(
                self._beam, self._init_log, self._chunk_logs)[0]
        return self.info.search.traceback(
            self._beam, self._init_log, self._chunk_logs,
            self.info.fst)[0]

    def get_best_path_txt(self) -> str:
        res = self.get_best_path()
        return " ".join(self.info.words.words(res.get("words", [])))

    def get_word_alignment(self, frame_offset: int = 0
                           ) -> list[tuple[str, float, float]]:
        """Per-word time spans [(word, begin_s, end_s)] of the best path —
        the AlignTime result (ref: net-data-package.h:210, client parse
        src/client/py-client/asr-client-api.cc:119-126)."""
        from asr_decoder_tpu.align.word_align import (spans_to_align,
                                                      word_spans)
        fst = self.info.fst
        if fst is None:
            raise RuntimeError(
                "word alignment needs an arc-labeled StdFst graph "
                "(hclg/biglm-hclg)")
        res = self.get_best_path()
        spans = word_spans(res.get("arc_ids", []), fst.arc_ilabel,
                           fst.arc_olabel, frame_offset,
                           anchor=getattr(fst, "olabel_anchor", "start"))
        return spans_to_align(spans, self.info.words,
                              self.info.seconds_per_frame)

    def get_lattice(self, determinize: bool = True):
        """Raw (or determinized) lattice of the utterance so far — every
        graph type, like the reference's shared GetRawLattice
        (ref: GetLattice, kaldi-online-nnet3-my-decoder.h:336;
        online-decoder-base-inl.h:869-977 serves all decoder variants)."""
        ac = self.info.am_config
        if ac.skip_blank_frames and ac.block_pdf_pdfid >= 0:
            raise RuntimeError(
                "lattice output is unsupported with skip_blank_frames "
                "(CTC blank-skip is a best-path fast path; the reference "
                "likewise uses SkipBlockFrame only in best-path CTC "
                "decoders, ref old-decoder/optimize-ctc-faster-decoder.h)")
        logs = self._merged_logs()
        if logs is None:
            return None
        lls = np.concatenate(self._loglikes, axis=0)[None]
        T = lls.shape[1]
        mask = np.ones((1, T), bool)
        gt = self.info.config.graph_type
        if gt == "clg":
            lat = self.info.search.get_lattices(
                self._init_log, logs, lls, frame_mask=mask)[0]
        else:   # hclg / biglm-hclg share the StdFst-keyed signature
            lat = self.info.search.get_lattices(
                self._init_log, logs, lls, self.info.fst,
                frame_mask=mask)[0]
        if lat is None:
            return None
        if determinize and lat.num_states:
            try:
                lat = determinize_lattice(lat)
            except DeterminizeError:
                pass  # raw lattice fallback (it is acyclic by construction)
        return lat

    def get_nbest(self, n: int) -> list[dict]:
        """n-best word sequences with costs (ref: GetNbest/GetNbestTxt)."""
        lat = self.get_lattice(determinize=True)
        if lat is None or not lat.num_states:
            return []
        paths = nshortest(lat, n)
        out = []
        for p in paths:
            words = [a.olabel for a in p.arcs if a.olabel != 0]
            out.append(dict(words=words,
                            text=" ".join(self.info.words.words(words)),
                            graph_cost=p.graph_cost, am_cost=p.am_cost))
        return out

    def get_nbest_txt(self, n: int) -> list[str]:
        return [r["text"] for r in self.get_nbest(n)]

    # -- endpointing --------------------------------------------------------
    def endpoint_detected(self) -> bool:
        """True when trailing silence exceeds the endpoint rule
        (ref: EndpointDetected, kaldi-online-nnet3-my-decoder.h:344;
        requires use_energy_vad)."""
        cfg = self.info.config
        return (self.num_frames_decoded >= cfg.min_endpoint_frames
                and self._trailing_sil >= cfg.endpoint_sil_frames)
