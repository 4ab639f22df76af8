"""Service tests: protocol pack/unpack round-trip (ref:
src/service2/net-data-package-test.cc) and a real server+client end-to-end
decode over localhost TCP (ref: service2bin/run.sh smoke + thread-client
load generation), checked against a direct session decode."""

import asyncio

import numpy as np
import pytest

from asr_decoder_tpu.serving.client import AsyncAsrClient, load_generate
from asr_decoder_tpu.serving.protocol import (C2SPackage, DType, EndFlag,
                                              NbestResult, S2CPackage,
                                              SampleRate)
from asr_decoder_tpu.serving.server import AsrServer, SocketConfig
from asr_decoder_tpu.serving.session import OnlineDecoderSession

from test_session import make_info, make_wave


def test_c2s_roundtrip():
    rng = np.random.default_rng(0)
    samples = (rng.standard_normal(1000) * 3000).astype(np.int16)
    pkg = C2SPackage.from_samples(samples, dtype=DType.SHORT,
                                  audio_head=True, nbest=5, end_flag=True,
                                  n=7, lattice=True)
    raw = pkg.pack()
    got, dlen = C2SPackage.unpack_head(raw[:C2SPackage.head_size()])
    got.data = raw[C2SPackage.head_size():]
    assert dlen == len(got.data) == 2 * len(samples)
    assert got.audio_head and got.end_flag and got.lattice
    assert got.nbest == 5 and got.n == 7
    assert got.sample_rate == SampleRate.K16
    np.testing.assert_array_equal(got.samples(), samples.astype(np.float32))


def test_s2c_roundtrip():
    pkg = S2CPackage(end_flag=EndFlag.MIDDLEEND,
                     results=[NbestResult("hello world", 1.5, -2.5, [3, 4]),
                              NbestResult("hello", 2.0, -1.0, [3])],
                     lattice=b"\x00\x01lattice-bytes")
    got = S2CPackage.unpack(pkg.pack())
    assert got.end_flag == EndFlag.MIDDLEEND
    assert got.one_best() == "hello world"
    assert got.results[0].words == [3, 4]
    assert got.results[1].am_cost == pytest.approx(-1.0)
    assert got.lattice == pkg.lattice


def test_s2c_warn_flag_roundtrip():
    pkg = S2CPackage(end_flag=EndFlag.END, warn=True,
                     results=[NbestResult("x", 0.0, 0.0, [1])])
    got = S2CPackage.unpack(pkg.pack())
    assert got.warn and got.end_flag == EndFlag.END
    assert not S2CPackage.unpack(S2CPackage().pack()).warn


def test_server_surfaces_biglm_overflow_warn(info):
    """A per-utterance BigLM lm_lanes overflow must reach the client as
    the S2C warn bit (the reference never drops candidates,
    ref online-decoder-mempool-base-biglm.h:316-402 — a drop here must be
    visible in-band)."""
    wave = make_wave(2, n=8000)

    async def run():
        server = AsrServer(info, SocketConfig(port=0, num_channels=2))
        real = server._batcher.get_best_path_from

        def overflowing(snap):
            res = real(snap)
            res["overflowed"] = True
            return res

        server._batcher.get_best_path_from = overflowing
        host, port = await server.start()
        try:
            client = AsyncAsrClient(host, port)
            await client.connect()
            reply = await client.decode_utterance(wave.astype(np.int16))
            await client.close()
            return reply
        finally:
            await server.stop()

    reply = asyncio.run(run())
    assert reply.warn


def test_c2s_nbest_cap():
    with pytest.raises(ValueError):
        C2SPackage(nbest=64).pack()


@pytest.fixture(scope="module")
def info():
    return make_info()


def test_server_end_to_end(info):
    wave = make_wave(7)
    ref_session = OnlineDecoderSession(info)
    ref_session.process_data(wave, eos=True)
    want_best = ref_session.get_best_path_txt()
    want_nbest = ref_session.get_nbest_txt(3)

    async def run():
        server = AsrServer(info, SocketConfig(port=0, num_channels=4))
        host, port = await server.start()
        try:
            client = AsyncAsrClient(host, port)
            await client.connect()
            replies = []
            pcm = wave.astype(np.int16)
            for off in range(0, len(pcm), 4000):
                end = off + 4000 >= len(pcm)
                replies.append(await client.send_chunk(
                    pcm[off:off + 4000], end=end, nbest=3))
            await client.close()
            return replies, server.total
        finally:
            await server.stop()

    replies, total = asyncio.run(run())
    assert all(r.end_flag == EndFlag.NOEND for r in replies[:-1])
    final = replies[-1]
    assert final.end_flag == EndFlag.END
    assert final.one_best() == want_best
    assert [r.text for r in final.results] == want_nbest
    assert total.wav_seconds == pytest.approx(len(wave) / 16000, rel=0.01)
    assert total.work_seconds > 0


def test_server_load_generator(info):
    waves = [make_wave(s, n=8000) for s in range(4)]
    want = []
    for w in waves:
        s = OnlineDecoderSession(info)
        s.process_data(w, eos=True)
        want.append(s.get_best_path_txt())

    async def run():
        server = AsrServer(info, SocketConfig(port=0, num_channels=4))
        host, port = await server.start()
        try:
            return await load_generate(waves, concurrency=2,
                                       host=host, port=port)
        finally:
            await server.stop()

    stats = asyncio.run(run())
    assert stats.utts == 4
    assert stats.wav_seconds == pytest.approx(sum(len(w) for w in waves)
                                              / 16000, rel=0.01)
    assert sorted(stats.texts) == sorted(want)


def test_server_batched_arena_16_clients(info):
    """≥16 concurrent streams decode through ONE channel arena: results
    equal per-session decoding, and the device loop genuinely batches —
    many channel-chunks per dispatch (the gpu-asr dynamic-batcher behavior,
    ref: src/gpu-asr/v1-gpu-kaldi-worker-pool.h:20-202)."""
    n_clients = 16
    waves = [make_wave(100 + s, n=8000) for s in range(n_clients)]
    want = []
    for w in waves:
        s = OnlineDecoderSession(info)
        s.process_data(w, eos=True)
        want.append(s.get_best_path_txt())

    async def run():
        server = AsrServer(info, SocketConfig(port=0,
                                              num_channels=n_clients))
        host, port = await server.start()
        try:
            async def one(w):
                client = AsyncAsrClient(host, port)
                await client.connect()
                try:
                    reply = await client.decode_utterance(w,
                                                          chunk_samples=4000)
                    return reply.one_best()
                finally:
                    await client.close()
            texts = await asyncio.gather(*(one(w) for w in waves))
            return list(texts), server.dispatches, server.chunks_decoded
        finally:
            await server.stop()

    texts, dispatches, chunks = asyncio.run(run())
    assert texts == want                       # (a) parity with sessions
    assert chunks >= n_clients                 # every stream went through
    # (b) real batching: the arena packed multiple channels per dispatch
    assert chunks / max(dispatches, 1) >= 3.0, (chunks, dispatches)


def test_word_spans_unit():
    """word_spans: olabel arcs open word-start-anchored spans; frames are
    counted over nonzero-ilabel arcs."""
    from asr_decoder_tpu.align.word_align import word_spans
    #        arc:    0    1    2    3    4    5
    ilabel = np.array([0, 3, 4, 0, 5, 6])
    olabel = np.array([0, 7, 0, 8, 0, 0])
    spans = word_spans([0, 1, 2, 3, 4, 5], ilabel, olabel)
    # word 7 at arc1 (frame 0); word 8 at arc3 (2 frames consumed);
    # last word runs to the end (4 frames total)
    assert spans == [(7, 0, 2), (8, 2, 4)]
    # frame_offset shifts everything (endpoint-resumed segments)
    spans = word_spans([0, 1, 2, 3, 4, 5], ilabel, olabel, frame_offset=10)
    assert spans == [(7, 10, 12), (8, 12, 14)]
    # end-anchored (label-pushed-late graphs): olabel arc CLOSES its span
    #        arc:    0    1    2    3    4    5
    ilabel = np.array([3, 4, 0, 5, 6, 0])
    olabel = np.array([0, 0, 7, 0, 0, 8])
    spans = word_spans([0, 1, 2, 3, 4, 5], ilabel, olabel, anchor="end")
    assert spans == [(7, 0, 2), (8, 2, 4)]
    # an emitting olabel arc's own frame belongs to the closing word
    ilabel = np.array([3, 4, 5, 6])
    olabel = np.array([0, 7, 0, 8])
    spans = word_spans([0, 1, 2, 3], ilabel, olabel, anchor="end")
    assert spans == [(7, 0, 2), (8, 2, 4)]


def test_word_alignment_trie_graph_end_anchor():
    """share_prefixes=True pushes each word's olabel to its exit arc; the
    graph records olabel_anchor='end' and word alignment must report spans
    covering the word's OWN frames, not its successor's (advisor r4
    medium: the start-anchored convention silently shifted spans by one
    word on trie graphs)."""
    from asr_decoder_tpu.align.word_align import word_spans
    from asr_decoder_tpu.fst.ctc_graph import build_ctc_decode_graph
    from asr_decoder_tpu.ops.beamsearch import TpuBeamSearch
    from asr_decoder_tpu.decoder.config import DecoderConfig

    lexicon = {1: [1, 2], 2: [1, 3], 3: [3]}
    fst, i2p = build_ctc_decode_graph(lexicon, {}, num_phones=3,
                                      share_prefixes=True)
    assert fst.olabel_anchor == "end"
    from asr_decoder_tpu.fst.device_fst import DeviceFst
    dev = DeviceFst.build(fst, arc_lanes=8)
    cfg = DecoderConfig(beam=1e9, beam_width=64, arc_lanes=8, max_active=64,
                        min_active=4, eps_mode="closure")
    search = TpuBeamSearch(dev, np.asarray(i2p, np.int32), cfg)
    # posteriors spelling word 1 (phones 1,2) then word 3 (phone 3):
    # frames: p1 p1 p2 blank p3  → "1 3"
    V = 5                    # blank row 0 + phones 1..3 (pdf rows 1..3)
    seq = [1, 1, 2, 0, 3]
    ll = np.full((1, len(seq), V), -10.0, np.float32)
    for t, p in enumerate(seq):
        ll[0, t, p if p else 0] = 0.0
        if p == 0:
            ll[0, t, 4] = -20.0
    # blank pdf is row 0 via ilabel2pdf (blank_il -> 0)
    st, il, lg = search.decode(ll)
    res = search.traceback(st, il, lg, fst)[0]
    assert res["words"] == [1, 3], res
    spans = word_spans(res["arc_ids"], fst.arc_ilabel, fst.arc_olabel,
                       anchor=fst.olabel_anchor)
    assert [s[0] for s in spans] == [1, 3]
    # word 1 owns its own acoustic frames (p1 p1 p2 + the in-word blank
    # its path consumed), word 3 owns the trailing p3 frame — under the
    # old start-anchored convention these spans came out shifted one
    # word late ((1, 4, 5)-style), the advisor-r4 bug
    assert spans == [(1, 0, 4), (3, 4, 5)], spans


def test_server_align_payload(info):
    """ali_info=1 returns per-word time spans in S2C (ref AlignTime,
    net-data-package.h:210): words match the 1-best, spans are
    non-overlapping and monotone."""
    wave = make_wave(21)
    sess = OnlineDecoderSession(info)
    sess.process_data(wave, eos=True)
    want_align = sess.get_word_alignment()

    async def run():
        server = AsrServer(info, SocketConfig(port=0, num_channels=2))
        host, port = await server.start()
        try:
            client = AsyncAsrClient(host, port)
            await client.connect()
            reply = await client.decode_utterance(
                wave.astype(np.int16), ali_info=True, score_info=True)
            await client.close()
            return reply
        finally:
            await server.stop()

    reply = asyncio.run(run())
    assert reply.ali_info and reply.score_info
    assert [w for w, _, _ in reply.align] == reply.one_best().split()
    assert reply.align == [(w, pytest.approx(b), pytest.approx(e))
                           for w, b, e in want_align]
    last_end = 0.0
    for _, b, e in reply.align:
        assert b >= last_end - 1e-6 and e >= b
        last_end = e


def test_server_slow_final_does_not_stall_other_channels(info):
    """A slow result build on one channel must not block another channel's
    streaming partials (the reference isolates result/rescore work from
    decode threads, ref src/post-processing-service/)."""
    import time as _time
    wave = make_wave(5, n=16000)

    async def run():
        server = AsrServer(info, SocketConfig(port=0, num_channels=4,
                                              result_workers=2))
        host, port = await server.start()
        real_results = server._results

        def slow_results(snap, pkg, final, pw, pa, pf):
            if final:
                _time.sleep(3.0)
            return real_results(snap, pkg, final, pw, pa, pf)

        server._results = slow_results
        try:
            slow = AsyncAsrClient(host, port)
            fast = AsyncAsrClient(host, port)
            await slow.connect()
            await fast.connect()
            pcm = wave.astype(np.int16)
            # stream the slow client up to its (sleeping) final...
            for off in range(0, 12000, 4000):
                await slow.send_chunk(pcm[off:off + 4000])
            final_task = asyncio.ensure_future(
                slow.send_chunk(pcm[12000:], end=True))
            await asyncio.sleep(0.1)   # let the slow final start sleeping
            # ...the fast client's partials must still flow promptly
            t0 = _time.monotonic()
            await fast.send_chunk(pcm[:4000])
            fast_latency = _time.monotonic() - t0
            await final_task
            await fast.send_chunk(pcm[4000:], end=True)
            await slow.close()
            await fast.close()
            return fast_latency
        finally:
            await server.stop()

    fast_latency = asyncio.run(run())
    # the partial must not be serialized behind the 3 s sleeping final;
    # the margin is generous because CI hosts can be CPU-contended
    assert fast_latency < 2.0, f"partial stalled {fast_latency:.2f}s " \
        "behind a slow final"


def test_server_endpoint_accumulates_text(info):
    """After a MIDDLEEND endpoint restart, later replies must carry the
    accumulated text of earlier segments (ref: the v1 worker's
    _best_result accumulation, kaldi-v1-asr-online.h:795-840)."""
    from test_session import make_info as mk
    vad_info = mk(use_energy_vad=True, endpoint_sil_frames=20,
                  min_endpoint_frames=10)
    rng = np.random.default_rng(11)
    loud1 = (rng.standard_normal(8000) * 4000).astype(np.float32)
    sil = np.zeros(8000, np.float32)
    loud2 = (rng.standard_normal(8000) * 4000).astype(np.float32)
    wave = np.concatenate([loud1, sil, loud2])

    async def run():
        server = AsrServer(vad_info, SocketConfig(port=0, num_channels=2))
        host, port = await server.start()
        try:
            client = AsyncAsrClient(host, port)
            await client.connect()
            pcm = wave.astype(np.int16)
            replies = []
            for off in range(0, len(pcm), 4000):
                end = off + 4000 >= len(pcm)
                replies.append(await client.send_chunk(pcm[off:off + 4000],
                                                       end=end))
            await client.close()
            return replies
        finally:
            await server.stop()

    replies = asyncio.run(run())
    middle = [r for r in replies if r.end_flag == EndFlag.MIDDLEEND]
    assert middle, "no endpoint fired (tune VAD thresholds)"
    seg1_text = middle[0].one_best()
    final_text = replies[-1].one_best()
    assert replies[-1].end_flag == EndFlag.END
    if seg1_text:
        # the final reply carries segment-1 text plus whatever followed
        assert final_text.startswith(seg1_text)


def test_native_client_end_to_end(info):
    """The C++ client library (native/asr_client.cc via ctypes, mirroring
    the reference's libclient.so + py-client, ref
    src/client/py-client/client.py:14-60) must decode identically to the
    Python client path."""
    pytest.importorskip("ctypes")
    from asr_decoder_tpu.serving.native_client import (NativeAsrClient,
                                                       NativeClientUnavailable)
    try:
        from asr_decoder_tpu.serving import native_client
        native_client._build_lib()
    except NativeClientUnavailable:
        pytest.skip("no g++ toolchain available")

    wave = make_wave(3)
    ref_session = OnlineDecoderSession(info)
    ref_session.process_data(wave, eos=True)
    want_best = ref_session.get_best_path_txt()

    async def run():
        server = AsrServer(info, SocketConfig(port=0, num_channels=4))
        host, port = await server.start()
        try:
            def client_work():
                with NativeAsrClient(host, port) as c:
                    text = c.decode_utterance(wave.astype(np.int16))
                with NativeAsrClient(host, port) as c:
                    # align parse path (ref AlignTime client parse,
                    # src/client/py-client/asr-client-api.cc:119-126)
                    t2, end = c.send_chunk(wave.astype(np.int16), eos=True,
                                           ali_info=True)
                    return text, t2, end, c.last_align
            return await asyncio.to_thread(client_work)
        finally:
            await server.stop()

    got, t2, end, align = asyncio.run(run())
    assert got == want_best
    assert t2 == want_best and end == 2
    assert [w for w, _, _ in align] == want_best.split() if want_best \
        else align == []
