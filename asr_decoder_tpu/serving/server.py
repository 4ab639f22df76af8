"""Streaming ASR TCP service over a batched channel arena.

Capability parity with the reference v2 service stack — socket setup with
keepalive tuning (ref: src/service2/socket-class.h:19-70), the worker pool
(ref: src/service2/thread-pool.h:16-66), the per-connection task loop with
3-strike receive timeout and zero-chunk EOS repair
(ref: src/v1-asr/v1-asr-task.h:83-110, src/v2-asr/v2-asr-task.h:57-327),
and per-utterance RTF accounting (ref: src/service2/thread-info.h:10-23,
v1-asr/v1-asr-task.h:238-251) — **and** with the reference's GPU serving
architecture: a dynamic batcher that packs chunks from many streaming
channels into one device dispatch
(ref: src/gpu-asr/v1-gpu-kaldi-worker-pool.h:20-202, conf
--max-batch-size=300 --num-channels=900, src/gpu-asr/conf/config.txt).

Device-first design: connections are asyncio coroutines (the reference's
1-thread-per-connection becomes 1-coroutine-per-connection) that push PCM
into per-connection channels of one ``BatchedStreamingDecoder`` arena; a
single device-loop coroutine ticks the arena — every tick is ONE jitted
AM+search dispatch advancing every channel with a ready chunk, so N
concurrent streams cost one XLA program per tick instead of N.  All
device/host-model access is serialized through a 1-thread executor (the
arena is single-writer by design; parallelism is *inside* the batched
dispatch, not across Python threads).
"""

from __future__ import annotations

import asyncio
import socket as socketlib
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import suppress
from dataclasses import dataclass

from asr_decoder_tpu.serving.batcher import BatchedStreamingDecoder
from asr_decoder_tpu.serving.protocol import (C2SPackage, EndFlag,
                                              NbestResult, S2CPackage,
                                              frame_s2c, read_c2s)
from asr_decoder_tpu.serving.session import OnlineDecoderInfo
from asr_decoder_tpu.utils.config import ConfigOptions, flag
from asr_decoder_tpu.utils.logging import get_logger

LOG = get_logger("serving")


@dataclass
class SocketConfig:
    """ref: SocketConf (service2/socket-class.h:19-67)."""
    ip: str = flag("127.0.0.1", "Listen address")
    port: int = flag(8100, "Listen port")
    num_channels: int = flag(
        32, "Streaming channels in the batched device arena (admission "
            "limit; ref --num-channels, gpu-asr/conf/config.txt)")
    rec_timeout: int = flag(30, "Per-package receive timeout (s)")
    timeout_strikes: int = flag(
        3, "Consecutive receive timeouts before disconnect "
           "(ref v1-asr-task.h:83-92)")
    advertise_rescore: bool = flag(
        False, "Set do_rescore on final replies that carry a lattice, "
               "telling clients to forward it to the post-processing "
               "service (ref S2C do_rescore)")
    result_workers: int = flag(
        2, "Threads for heavy result building (traceback/lattice/"
           "determinize/n-best) so one client's expensive final never "
           "stalls the device loop (ref: result work isolated from decode "
           "threads, src/post-processing-service/)")
    keepalive: bool = flag(True, "Enable TCP keepalive on connections")
    keep_idle: int = flag(120, "TCP_KEEPIDLE seconds")
    keep_interval: int = flag(10, "TCP_KEEPINTVL seconds")
    keep_count: int = flag(3, "TCP_KEEPCNT probes")

    def register(self, opts: ConfigOptions, prefix: str = "") -> None:
        opts.register_dataclass(self, prefix)


@dataclass
class UttStats:
    """Per-utterance timing (ref: ThreadTimeInfo semantics)."""
    wav_seconds: float = 0.0
    work_seconds: float = 0.0

    @property
    def rtf(self) -> float:
        return self.work_seconds / self.wav_seconds if self.wav_seconds else 0.0


class AsrServer:
    def __init__(self, info: OnlineDecoderInfo,
                 socket_config: SocketConfig | None = None):
        self.info = info
        self.config = socket_config or SocketConfig()
        # single-writer executor: every arena call (host frontend + device
        # dispatch) runs here; batching happens inside the dispatch
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="device")
        # result executor: heavy result building runs over immutable
        # channel snapshots here, so a slow lattice/n-best final on one
        # channel never blocks other channels' dispatches
        self._result_pool = ThreadPoolExecutor(
            max_workers=max(1, self.config.result_workers),
            thread_name_prefix="results")
        self._batcher = BatchedStreamingDecoder(info,
                                                self.config.num_channels)
        self._chan_sem = asyncio.Semaphore(self.config.num_channels)
        self._work = asyncio.Event()
        self._chan_events: dict[int, asyncio.Event] = {}
        self._server: asyncio.AbstractServer | None = None
        self._device_task: asyncio.Task | None = None
        self.total = UttStats()
        self.dispatches = 0       # batched device steps
        self.chunks_decoded = 0   # channel-chunks consumed across dispatches

    async def _run(self, fn, *args):
        return await asyncio.get_running_loop().run_in_executor(
            self._pool, fn, *args)

    async def _run_result(self, fn, *args):
        return await asyncio.get_running_loop().run_in_executor(
            self._result_pool, fn, *args)

    # -- lifecycle ---------------------------------------------------------
    async def start(self) -> tuple[str, int]:
        self._server = await asyncio.start_server(
            self._handle, self.config.ip, self.config.port)
        self._device_task = asyncio.ensure_future(self._device_loop())
        addr = self._server.sockets[0].getsockname()[:2]
        LOG.info("listening on %s:%d (%d channels)", *addr,
                 self.config.num_channels)
        return addr

    async def stop(self) -> None:
        if self._device_task is not None:
            self._device_task.cancel()
            with suppress(asyncio.CancelledError):
                await self._device_task
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        self._pool.shutdown(wait=True)
        self._result_pool.shutdown(wait=True)

    async def serve_forever(self) -> None:
        await self.start()
        assert self._server is not None
        async with self._server:
            await self._server.serve_forever()

    # -- the batched device loop (ref DynamicBatcher compute cycle) --------
    async def _device_loop(self) -> None:
        """Tick the arena whenever any connection has pushed work: each
        step() is one batched dispatch over every ready channel."""
        while True:
            await self._work.wait()
            self._work.clear()
            while True:
                advanced = await self._run(self._batcher.step)
                if not advanced:
                    break
                self.dispatches += 1
                self.chunks_decoded += len(advanced)
                for cid in advanced:
                    ev = self._chan_events.get(cid)
                    if ev is not None:
                        ev.set()

    async def _pump(self, cid: int) -> None:
        """Block until the device loop has consumed every ready chunk of
        this channel (clear-before-check: step() only completes inside the
        same 1-thread executor as ready(), so a set() between our check and
        wait() is always observed)."""
        ev = self._chan_events[cid]
        while True:
            ev.clear()
            if not await self._run(self._batcher.ready, cid):
                return
            self._work.set()
            await ev.wait()

    # -- per-connection task loop (ref: v2-asr-task.h:57-327) --------------
    def _tune_socket(self, writer: asyncio.StreamWriter) -> None:
        """TCP keepalive tuning (ref socket-class.h:24-31)."""
        sock = writer.get_extra_info("socket")
        if sock is None or not self.config.keepalive:
            return
        with suppress(OSError):
            sock.setsockopt(socketlib.SOL_SOCKET,
                            socketlib.SO_KEEPALIVE, 1)
            sock.setsockopt(socketlib.IPPROTO_TCP,
                            socketlib.TCP_KEEPIDLE, self.config.keep_idle)
            sock.setsockopt(socketlib.IPPROTO_TCP,
                            socketlib.TCP_KEEPINTVL,
                            self.config.keep_interval)
            sock.setsockopt(socketlib.IPPROTO_TCP,
                            socketlib.TCP_KEEPCNT, self.config.keep_count)

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        self._tune_socket(writer)
        cid: int | None = None
        stats = UttStats()
        sr = 16000
        strikes = 0
        # endpoint-accumulated result state: text/align of completed
        # segments is prepended to later replies (ref: the v1 worker's
        # _best_result accumulation, kaldi-v1-asr-online.h:795-840)
        prefix_words: list[int] = []
        prefix_align: list = []
        prefix_frames = 0
        try:
            while True:
                try:
                    pkg = await asyncio.wait_for(
                        read_c2s(reader), self.config.rec_timeout)
                    strikes = 0
                except asyncio.TimeoutError:
                    # 3-strike disconnect (ref v1-asr-task.h:83-92)
                    strikes += 1
                    if strikes >= self.config.timeout_strikes:
                        LOG.warning("receive timeout ×%d, disconnecting",
                                    strikes)
                        break
                    continue
                except (asyncio.IncompleteReadError, ConnectionError):
                    break
                if cid is not None and not pkg.data and not pkg.end_flag:
                    # zero-length mid-stream chunk: forced-EOS repair
                    # (ref v1-asr-task.h:105-110)
                    pkg.end_flag = True
                if cid is None or pkg.audio_head:
                    if cid is not None:
                        await self._close_channel(cid)
                        cid = None
                    await self._chan_sem.acquire()
                    cid = await self._run(self._batcher.acquire)
                    self._chan_events[cid] = asyncio.Event()
                    stats = UttStats()
                    sr = pkg.sample_rate.hz
                    prefix_words, prefix_align, prefix_frames = [], [], 0
                samples = pkg.samples()
                stats.wav_seconds += len(samples) / sr
                t0 = time.monotonic()
                await self._run(self._batcher.push, cid, samples,
                                bool(pkg.end_flag))
                await self._pump(cid)
                endpoint = (not pkg.end_flag
                            and self._batcher.endpoint_detected(cid))
                # snapshot under the device writer, build results off it:
                # heavy finals never stall other channels' dispatches
                snap = await self._run(self._batcher.snapshot, cid)
                reply, seg_words, seg_align = await self._run_result(
                    self._results, snap, pkg,
                    bool(pkg.end_flag) or endpoint,
                    prefix_words, prefix_align, prefix_frames)
                stats.work_seconds += time.monotonic() - t0
                writer.write(frame_s2c(reply))
                await writer.drain()
                if pkg.end_flag:
                    LOG.info("utt done: wav=%.2fs work=%.2fs rtf=%.4f",
                             stats.wav_seconds, stats.work_seconds,
                             stats.rtf)
                    self.total.wav_seconds += stats.wav_seconds
                    self.total.work_seconds += stats.work_seconds
                    await self._close_channel(cid)
                    cid = None
                elif endpoint:
                    # mid-stream endpoint: restart search, keep stream;
                    # fold the finished segment into the reply prefix
                    # (ref: MIDDLEEND + InitDecoding(frame_offset) +
                    # _best_result accumulation)
                    prefix_words = prefix_words + seg_words
                    prefix_align = prefix_align + seg_align
                    prefix_frames += snap.frames_decoded
                    await self._run(self._batcher.init_decoding, cid)
        finally:
            if cid is not None:
                await self._close_channel(cid)
            writer.close()
            try:
                await writer.wait_closed()
            except ConnectionError:
                pass

    async def _close_channel(self, cid: int) -> None:
        await self._run(self._batcher.release, cid)
        self._chan_events.pop(cid, None)
        self._chan_sem.release()

    def _results(self, snap, pkg: C2SPackage, final: bool,
                 prefix_words: list[int], prefix_align: list,
                 prefix_frames: int
                 ) -> tuple[S2CPackage, list[int], list]:
        """Build the S2C reply from a channel snapshot (ref:
        v2-asr-task.h SendDataAndGetResult).  Runs on the result pool —
        only touches the immutable snapshot, never live channel state.
        Returns (reply, segment_words, segment_align) so the caller can
        fold finished segments into the prefix at endpoints."""
        end = (EndFlag.END if pkg.end_flag
               else EndFlag.MIDDLEEND if final else EndFlag.NOEND)
        reply = S2CPackage(end_flag=end)
        prefix_text = " ".join(self.info.words.words(prefix_words))

        def with_prefix(text: str) -> str:
            return f"{prefix_text} {text}".strip() if prefix_text else text

        best = self._batcher.get_best_path_from(snap)
        seg_words = list(best.get("words", []))
        n = max(1, pkg.nbest) if final else 1
        if final and pkg.nbest > 1:
            for r in self._batcher.get_nbest_from(snap, n):
                reply.results.append(NbestResult(
                    with_prefix(r["text"]), r["graph_cost"], r["am_cost"],
                    prefix_words + r["words"]))
        if not reply.results:
            reply.results.append(NbestResult(
                with_prefix(" ".join(self.info.words.words(seg_words))),
                best.get("cost", 0.0), 0.0, prefix_words + seg_words))
        if best.get("overflowed"):
            # BigLM lm_lanes overflow dropped word candidates for this
            # utterance: never silent (ref never drops,
            # online-decoder-mempool-base-biglm.h:316-402) — warn the
            # client in-band and the operator in logs
            reply.warn = True
            LOG.warning("biglm lm_lanes overflow on this utterance: "
                        "results may be inexact (raise lm_lanes)")
        # per-word time spans are computed at EVERY reply that can fold a
        # segment into the prefix, not only when this chunk requested
        # ali_info — otherwise a client asking for alignment only on its
        # final chunk would get full-utterance text but last-segment-only
        # alignment; pkg.ali_info gates only whether the payload is SENT
        # (ref AlignTime, net-data-package.h:210)
        seg_align: list = []
        if self.info.fst is not None:
            from asr_decoder_tpu.align.word_align import (spans_to_align,
                                                          word_spans)
            spans = word_spans(best.get("arc_ids", []),
                               self.info.fst.arc_ilabel,
                               self.info.fst.arc_olabel, prefix_frames,
                               anchor=getattr(self.info.fst,
                                              "olabel_anchor", "start"))
            seg_align = spans_to_align(spans, self.info.words,
                                       self.info.seconds_per_frame)
        if pkg.ali_info and self.info.fst is not None:
            reply.align = prefix_align + seg_align
            reply.ali_info = True
        if pkg.score_info:
            # per-result (graph, acoustic) costs already ride every
            # NbestResult; the flag marks them as requested (ref score
            # payload, net-data-package.h:561-755)
            reply.score_info = True
        if final and pkg.lattice:
            lat = self._batcher.get_lattice_from(snap, determinize=True)
            if lat is not None:
                # binary lattice payload — feeds the post-processing
                # (rescore) service (ref S2C lattice + do_rescore flow,
                # net-data-package.h:561-755)
                reply.lattice = lat.to_bytes()
                reply.do_rescore = self.config.advertise_rescore
        return reply, seg_words, seg_align


def run_server(info: OnlineDecoderInfo,
               socket_config: SocketConfig | None = None) -> None:
    asyncio.run(AsrServer(info, socket_config).serve_forever())
