"""Smoke test of the served decode path on a GPU, at the flagship's width.

    python chip_smoke.py [--seed N]           one card
    python chip_smoke.py --four [--seed N]    four cards: the sharded paths

One card runs five phases, each printing one line with its result, its wall
time and its compile time:

  device         fail unless JAX's default device is a GPU; print the card's
                 name and power limit (nvidia-smi) and the compile cache.
  serve          write the flagship AM, the 200k-state headline graph and
                 words.txt from the seed under build/, build the server the
                 way ``cli/serve.py`` does, decode 8 utterances of 8 s over
                 localhost TCP (8 clients at once), and check every final
                 answer against a direct ``OnlineDecoderSession`` decode.
  am-parity      the flagship fbank+AM on 4 utterances: the card at
                 "highest" precision against the CPU backend (≤ 1e-3), and
                 at default (TF32) precision (≤ TF32_MAX_ABS over the
                 first TF32_FRAMES frames; whole-utterance error printed).
  search-parity  the headline search on the card (B=256) against the CPU
                 backend (B=8) on the same loglikes; the search on the
                 composed production TLG against the host GoldDecoder.
  ops            the search's XLA acoustic-score gather and state-record
                 fetch at production and headline shapes, bit-exact against
                 numpy: median of 20 lone calls, and the time per call
                 inside one program (100 calls in a loop).

``--four`` runs only the paths that span cards: a dp=4 serving arena, the
dp-sharded production decode and a dp=2 × tp=2 flagship AM, each against
one card.

The last line of stdout is ``{"ok": true, "device": {...}}``; any failed
check raises before it, so the exit code is then non-zero.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import statistics
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
AM_HIGHEST_MAX_ABS = 1e-3
# TF32 keeps 10 mantissa bits (relative rounding ~5e-4 per operand).  Over
# the first TF32_FRAMES output frames (a short recurrence) ~1e-2 is expected
# on log-likelihoods of magnitude ~10; the bound is ten times that.  Over a
# whole utterance the random-weight LSTM carries every rounding difference
# through ~270 recurrent steps (max|d| 0.32 over 266 frames on an H100), so
# the full-utterance max and the top-1 pdf agreement are printed, with the
# error per frame range, and not bounded.
TF32_MAX_ABS = 1e-1
TF32_FRAMES = 16
SEARCH_REL_TOL = 1e-4
GOLD_ABS_TOL, GOLD_REL_TOL = 1e-3, 1e-5

_compile_s = [0.0]


class SmokeFailure(RuntimeError):
    pass


def check(ok, detail=None) -> None:
    """Raise (never skipped, unlike ``assert`` under -O) unless ``ok``."""
    if not ok:
        raise SmokeFailure(detail)


def _on_compile_event(name, secs, **_):
    if name.startswith("/jax/core/compile/"):
        _compile_s[0] += secs


class Phase:
    """Times one phase; prints ``[name] ok ...`` only if it finished."""

    def __init__(self, name: str):
        self.name = name
        self.notes: list[str] = []

    def note(self, msg: str) -> None:
        self.notes.append(msg)

    def __enter__(self):
        self.t0 = time.perf_counter()
        self.c0 = _compile_s[0]
        return self

    def __exit__(self, exc_type, *_):
        if exc_type is None:
            wall = time.perf_counter() - self.t0
            comp = _compile_s[0] - self.c0
            print(f"[{self.name}] ok wall_s={wall:.1f} compile_s={comp:.1f}"
                  + "".join(f"\n  {n}" for n in self.notes), flush=True)
        return False


def _median_time(fn, *args, reps: int = 20) -> float:
    import jax
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _compare_rows(got: list[dict], want: list[dict]) -> str:
    """Words identical and costs within SEARCH_REL_TOL·|cost| (float32
    sums in another order or batch shape); returns a summary."""
    for b, (g, w) in enumerate(zip(got, want)):
        check(g["words"] == w["words"], (b, g["words"], w["words"]))
        d = abs(g["cost"] - w["cost"])
        check(d <= SEARCH_REL_TOL * abs(w["cost"]),
              (b, g["cost"], w["cost"]))
    same = sum(g["cost"] == w["cost"] for g, w in zip(got, want))
    dmax = max(abs(g["cost"] - w["cost"]) for g, w in zip(got, want))
    return (f"{len(got)}/{len(want)} rows same words, costs bit-identical "
            f"in {same}, max|dcost|={dmax:.3g}")


def write_model(seed: int) -> tuple[Path, Path, Path]:
    """Flagship nnet, headline graph and words.txt from the seed, under a
    fixed build/ directory."""
    import jax

    from asr_decoder_tpu.eval import operating_points as op
    from asr_decoder_tpu.fst.symbol import SymbolTable
    from asr_decoder_tpu.models.flagship import make_flagship

    out = ROOT / "build" / "chip_smoke" / f"seed{seed}"
    out.mkdir(parents=True, exist_ok=True)
    am, graph, words = (out / "final.nnet", out / "graph.bin",
                        out / "words.txt")
    make_flagship(jax.random.PRNGKey(seed), **op.FLAGSHIP).write_binary(
        str(am))
    fst, _ = op.headline_graph(seed)
    fst.write_binary(str(graph))
    table = SymbolTable()
    table.add("<eps>", 0)
    for i in range(1, int(fst.arc_olabel.max()) + 1):
        table.add(f"w{i}", i)
    table.write_text(str(words))
    return am, graph, words


def build_served_info(seed: int):
    """OnlineDecoderInfo parsed from argv exactly as ``cli/serve.py`` does."""
    from asr_decoder_tpu.cli._model import build_info, register_info_flags
    from asr_decoder_tpu.eval import operating_points as op
    from asr_decoder_tpu.utils.config import ConfigOptions

    am, graph, words = write_model(seed)
    cfg = op.headline_config()
    argv = [f"--{k.replace('_', '-')}={getattr(cfg, k)}"
            for k in ("beam", "beam_width", "max_active", "min_active",
                      "arc_lanes", "eps_mode")]
    argv += [f"--fbank.num-bins={op.FLAGSHIP['feat_dim']}",
             f"--am.skip={op.SKIP}", "--ctc-blank-shift=true",
             str(am), str(graph), str(words)]
    opts = ConfigOptions(usage="chip_smoke")
    flags = register_info_flags(opts)
    pos = opts.parse(argv)
    return build_info(*pos, *flags)


def make_waves(rng, n: int, secs: float = 8.0) -> np.ndarray:
    return np.clip(rng.standard_normal((n, int(16000 * secs))) * 3000,
                   -32768, 32767).astype(np.int16)


def phase_device() -> dict:
    from asr_decoder_tpu.utils.device import (device_info,
                                              enable_compile_cache,
                                              gpu_name_and_power_limit,
                                              require_gpu)
    with Phase("device") as ph:
        require_gpu()
        cache = enable_compile_cache()
        info = device_info()
        card = gpu_name_and_power_limit()
        ph.note(f"device_kind={info['kind']} count={info['count']}")
        ph.note(f"compile_cache={cache}")
    print(f"card: {card}", flush=True)
    return info


def phase_serve(ctx: dict, seed: int) -> None:
    import jax

    from asr_decoder_tpu.serving.client import AsyncAsrClient
    from asr_decoder_tpu.serving.protocol import EndFlag
    from asr_decoder_tpu.serving.server import AsrServer, SocketConfig
    from asr_decoder_tpu.serving.session import OnlineDecoderSession

    with Phase("serve") as ph:
        info = build_served_info(seed)
        ctx["info"] = info
        waves = make_waves(np.random.default_rng(seed + 10), 8)

        async def run():
            server = AsrServer(info, SocketConfig(port=0, num_channels=32))
            host, port = await server.start()

            async def one(wave):
                client = AsyncAsrClient(host, port)
                await client.connect()
                try:
                    return await client.decode_utterance(
                        wave, chunk_samples=16000)
                finally:
                    await client.close()
            try:
                return await asyncio.gather(*(one(w) for w in waves))
            finally:
                await server.stop()

        t0 = time.perf_counter()
        replies = asyncio.run(run())
        served_s = time.perf_counter() - t0
        for i, (wave, reply) in enumerate(zip(waves, replies)):
            got = reply.one_best()
            session = OnlineDecoderSession(info)
            session.process_data(wave.astype(np.float32), eos=True)
            want = session.get_best_path_txt()
            check(reply.end_flag == EndFlag.END, (i, reply.end_flag))
            check(got, f"utterance {i}: empty final answer")
            check(got == want, f"utterance {i}: served {got!r} != {want!r}")
            ph.note(f"utt {i}: {len(got.split())} words, matches session: "
                    f"{got[:60]!r}")
        peak = (jax.devices()[0].memory_stats() or {}).get(
            "peak_bytes_in_use")
        ph.note(f"8 x 8 s served in {served_s:.1f} s wall (incl. compile); "
                f"peak_bytes_in_use={peak}")


def _am_fn(layers, wave):
    from asr_decoder_tpu.eval import operating_points as op
    from asr_decoder_tpu.frontend.fbank import FbankConfig, compute_fbank
    from asr_decoder_tpu.models.layers import init_layer_state
    from asr_decoder_tpu.models.nnet import am_forward

    feats = compute_fbank(FbankConfig(num_bins=op.FLAGSHIP["feat_dim"]),
                          wave)
    state = [init_layer_state(l, wave.shape[0]) for l in layers]
    ll, _ = am_forward(layers, feats, state, skip=op.SKIP)
    return ll


def phase_am_parity(ctx: dict, seed: int) -> None:
    import jax

    from asr_decoder_tpu.eval import operating_points as op

    with Phase("am-parity") as ph:
        gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
        layers = ctx["info"].nnet.layers
        waves = make_waves(np.random.default_rng(seed + 20), 4).astype(
            np.float32)
        am = jax.jit(_am_fn)
        on = lambda d: (jax.device_put(layers, d), jax.device_put(waves, d))
        ll_tf32 = np.asarray(am(*on(gpu)))
        with jax.default_matmul_precision("highest"):
            ll_high = np.asarray(am(*on(gpu)))
            ll_cpu = np.asarray(am(*on(cpu)))
        check(ll_cpu.shape[::2] == (4, op.FLAGSHIP["num_pdfs"]),
              ll_cpu.shape)
        check(np.isfinite(ll_cpu).all())
        T = ll_cpu.shape[1]
        ranges = [(0, TF32_FRAMES), (TF32_FRAMES, 64), (64, 128), (128, T)]
        for name, ll in (("highest", ll_high), ("default (TF32)", ll_tf32)):
            err = np.abs(ll - ll_cpu).max(axis=(0, 2))      # per frame
            top1 = float((ll.argmax(-1) == ll_cpu.argmax(-1)).mean())
            ph.note(f"{name}: max|d|={err.max():.3g}, top1 agree="
                    f"{top1:.4f}, max|d| per frame range: " + ", ".join(
                        f"[{a},{b}) {err[a:b].max():.3g}" for a, b in ranges))
        ph.note(f"loglikes {ll_cpu.shape}, max|ll|="
                f"{np.abs(ll_cpu).max():.3g}")
        d_high = float(np.abs(ll_high - ll_cpu).max())
        d_tf32 = float(np.abs(ll_tf32 - ll_cpu)[:, :TF32_FRAMES].max())
        check(d_high <= AM_HIGHEST_MAX_ABS, d_high)
        check(d_tf32 <= TF32_MAX_ABS, d_tf32)
        ctx["ll_cpu"] = ll_cpu


def phase_search_parity(ctx: dict, seed: int) -> None:
    import jax

    from asr_decoder_tpu.decoder.gold import GoldDecoder
    from asr_decoder_tpu.eval import operating_points as op
    from asr_decoder_tpu.fst.device_fst import DeviceFst
    from asr_decoder_tpu.models.nnet import pack_nonblank_frames
    from asr_decoder_tpu.ops.beamsearch import TpuBeamSearch

    with Phase("search-parity") as ph:
        info = ctx["info"]
        cpu = jax.devices("cpu")[0]
        ll4 = ctx["ll_cpu"]
        # 8 distinct rows: the 4 utterances, then the same rolled in time
        ll8 = np.concatenate([ll4, np.roll(ll4, ll4.shape[1] // 3, axis=1)])
        search = info.search
        st, il, lg = search.decode(np.tile(ll8, (32, 1, 1)))
        got = search.traceback(st, il, lg, info.fst)[:8]
        ctx["headline_state"] = np.asarray(st.tok_state)
        with jax.default_device(cpu):
            search_cpu = TpuBeamSearch(search.dev, info.ilabel2pdf,
                                       info.decoder_config)
            want = search_cpu.traceback(
                *search_cpu.decode(jax.device_put(ll8, cpu)), info.fst)
        ph.note(f"headline B=256 card vs B=8 cpu, relax="
                f"{search.relax_impl}: " + _compare_rows(got, want))

        t0 = time.perf_counter()
        fst, i2p, lexicon = op.production_tlg()
        cfg = op.production_config()
        dev = DeviceFst.build(fst, arc_lanes=cfg.arc_lanes)
        prod = TpuBeamSearch(dev, i2p, cfg)
        ph.note(f"production TLG: {dev.num_states} states, "
                f"{fst.num_arcs} arcs, built in "
                f"{time.perf_counter() - t0:.1f} s")
        raw = op.tlg_posteriors(np.random.default_rng(seed + 30), lexicon,
                                op.PRODUCTION_PHONES, 32, 264)
        packed, mask = pack_nonblank_frames(raw, 0,
                                            thresh=float(np.log(0.75)))
        st, il, lg = prod.decode(packed, mask)
        got = prod.traceback(st, il, lg, fst)
        live = (np.asarray(st.tok_cost) < np.inf).sum(axis=1)
        gold = GoldDecoder(fst, i2p, cfg)
        for b in range(2):
            n = int(mask[b].sum())
            g = gold.decode(packed[b, :n])
            d = abs(got[b]["cost"] - g.cost)
            check(got[b]["words"] == g.words, (b, got[b]["words"], g.words))
            check(d <= GOLD_ABS_TOL + GOLD_REL_TOL * abs(g.cost),
                  (b, got[b]["cost"], g.cost))
            ph.note(f"production utt {b}: {n} frames, {len(g.words)} words "
                    f"== gold, |dcost|={d:.3g}")
        ph.note(f"production B=32 packed frames={packed.shape[1]} "
                f"final live mean={live.mean():.0f} relax={prod.relax_impl}")
        ctx.update(prod=prod, prod_ll=packed, prod_mask=mask,
                   prod_state=np.asarray(st.tok_state))


def _in_program_time(step, init, *arrays, reps: int = 100) -> float:
    """Device time of one ``step(i, acc, *arrays)`` inside a program: the
    step runs ``1 + reps`` times in one ``fori_loop`` and once, and the
    difference is divided by ``reps`` (removes the dispatch and sync floor
    that a lone call pays)."""
    import functools

    import jax
    loop = jax.jit(lambda n, *arrs: jax.lax.fori_loop(
        0, n, functools.partial(step, *arrs), init))
    t1 = _median_time(loop, 1, *arrays, reps=5)
    tn = _median_time(loop, 1 + reps, *arrays, reps=5)
    return max(tn - t1, 0.0) / reps


def phase_ops(ctx: dict, seed: int) -> None:
    import jax
    import jax.numpy as jnp

    from asr_decoder_tpu.ops.beamsearch import CLO_BIT
    from asr_decoder_tpu.ops.gather import (batched_table_gather,
                                            fetch_state_records)

    # one step = one call whose result is reduced into the carry; the
    # indices move with the loop counter so the call cannot be hoisted
    def gather_step(table, idx, i, acc):
        idx = (idx + i) % table.shape[1]
        return acc + batched_table_gather(table, idx).sum(axis=1)

    def fetch_step(records, state, i, acc):
        state = jnp.where(state >= 0, (state + i) % records.shape[0], state)
        return acc + fetch_state_records(records, state).sum(axis=(1, 2))

    with Phase("ops") as ph:
        rng = np.random.default_rng(seed + 40)
        prod = ctx["prod"]
        ll, mask = ctx["prod_ll"], ctx["prod_mask"]
        st0, _ = prod.init_state(ll.shape[0])
        ll_d, mask_d = jnp.asarray(ll), jnp.asarray(mask)
        t_adv = _median_time(lambda: prod.advance(st0, ll_d, mask_d)[0],
                             reps=3)
        frame_s = t_adv / ll.shape[1]
        ph.note(f"production search advance: {t_adv * 1e3:.1f} ms for "
                f"{ll.shape[1]} frames = {frame_s * 1e3:.3f} ms/frame")
        gather = jax.jit(batched_table_gather)
        fetch = jax.jit(fetch_state_records)
        shapes = {
            "production": (ll[:, 0], dict(prod._static), prod.pgraph.records,
                           ctx["prod_state"]),
            "headline": (ctx["ll_cpu"][:, 0].repeat(64, axis=0),
                         dict(ctx["info"].search._static),
                         ctx["info"].search.pgraph.records,
                         ctx["headline_state"]),
        }
        for name, (table, cfg, records, state) in shapes.items():
            B = state.shape[0]
            table = np.ascontiguousarray(table[:B])
            idx = rng.integers(0, table.shape[1],
                               (B, cfg["K"] * cfg["A"])).astype(np.int32)
            state = np.where(state >= 0, state & ~CLO_BIT, state)
            t_d, i_d, s_d = map(jnp.asarray, (table, idx, state))
            out = np.asarray(gather(t_d, i_d))
            check(np.array_equal(out, np.take_along_axis(table, idx, 1)))
            rec_np = np.asarray(records)
            out = np.asarray(fetch(records, s_d))
            check(np.array_equal(out, rec_np[np.maximum(state, 0)]))
            t_g = _median_time(gather, t_d, i_d)
            t_f = _median_time(fetch, records, s_d)
            d_g = _in_program_time(gather_step, jnp.zeros(B, jnp.float32),
                                   t_d, i_d)
            d_f = _in_program_time(fetch_step, jnp.zeros(B, jnp.int32),
                                   records, s_d)
            live = int((state >= 0).sum()) / B
            ph.note(f"{name}: acoustic gather table{table.shape} "
                    f"idx{idx.shape}: {t_g * 1e6:.1f} us/call alone, "
                    f"{d_g * 1e6:.1f} us in a program; bit-exact")
            ph.note(f"{name}: record fetch [{records.shape[0]}, "
                    f"{records.shape[1]}] x {state.shape} (live "
                    f"{live:.0f}/row): {t_f * 1e6:.1f} us/call alone, "
                    f"{d_f * 1e6:.1f} us in a program; bit-exact")
            if name == "production":
                ph.note(f"production share of a frame (in a program): "
                        f"gather 1x/frame {d_g / frame_s:.1%}, fetch "
                        f"2x/frame {2 * d_f / frame_s:.1%}")


def run_one_card(seed: int) -> dict:
    info = phase_device()
    ctx: dict = {}
    phase_serve(ctx, seed)
    phase_am_parity(ctx, seed)
    phase_search_parity(ctx, seed)
    phase_ops(ctx, seed)
    return info


def run_four_cards(seed: int) -> dict:
    import jax
    import jax.numpy as jnp

    from asr_decoder_tpu.eval import operating_points as op
    from asr_decoder_tpu.fst.device_fst import DeviceFst
    from asr_decoder_tpu.models.nnet import pack_nonblank_frames
    from asr_decoder_tpu.ops.beamsearch import TpuBeamSearch
    from asr_decoder_tpu.parallel.decode import dp_decode
    from asr_decoder_tpu.parallel.mesh import (data_sharding, make_mesh,
                                               shard_batch, shard_model)
    from asr_decoder_tpu.serving.batcher import BatchedStreamingDecoder

    info = phase_device()
    devices = jax.devices()
    check(len(devices) == 4, f"--four needs 4 GPUs, found {len(devices)}")

    with Phase("four-arena") as ph:
        waves = make_waves(np.random.default_rng(seed + 50), 8).astype(
            np.float32)

        def serve(mesh):
            arena = BatchedStreamingDecoder(build_served_info(seed), 8,
                                            mesh=mesh)
            cids = [arena.acquire() for _ in waves]
            for lo in range(0, waves.shape[1], 16000):
                for cid, w in zip(cids, waves):
                    arena.push(cid, w[lo:lo + 16000],
                               eos=lo + 16000 >= len(w))
                arena.drain()
            return [arena.get_best_path(c) for c in cids], arena

        with jax.default_matmul_precision("highest"):
            want, _ = serve(None)
            got, arena = serve(make_mesh(devices, tp=1))
        ndev = len(arena._beam.tok_cost.sharding.device_set)
        check(ndev == 4, ndev)
        ph.note(f"dp=4 arena, 8 streams x 8 s, beam on {ndev} devices: "
                + _compare_rows(got, want))

    with Phase("four-dp-decode") as ph:
        fst, i2p, lexicon = op.production_tlg()
        cfg = op.production_config()
        search = TpuBeamSearch(DeviceFst.build(fst, arc_lanes=cfg.arc_lanes),
                               i2p, cfg)
        raw = op.tlg_posteriors(np.random.default_rng(seed + 30), lexicon,
                                op.PRODUCTION_PHONES, 32, 264)
        packed, mask = pack_nonblank_frames(raw, 0,
                                            thresh=float(np.log(0.75)))
        want = search.traceback(*search.decode(packed, mask), fst)
        st, il, lg = dp_decode(make_mesh(devices, tp=1), search, packed,
                               mask)
        check(len(st.tok_cost.sharding.device_set) == 4)
        got = search.traceback(st, il, lg, fst)
        ph.note("dp_decode production TLG B=32 on 4 cards: "
                + _compare_rows(got, want))

    with Phase("four-tp-am") as ph:
        from asr_decoder_tpu.frontend.fbank import FbankConfig, compute_fbank
        from asr_decoder_tpu.models.flagship import make_flagship
        from asr_decoder_tpu.models.layers import init_layer_state
        from asr_decoder_tpu.models.nnet import am_forward

        layers = make_flagship(jax.random.PRNGKey(seed), **op.FLAGSHIP).layers
        waves = make_waves(np.random.default_rng(seed + 20), 4).astype(
            np.float32)
        feats = compute_fbank(FbankConfig(num_bins=op.FLAGSHIP["feat_dim"]),
                              jnp.asarray(waves))[:, ::op.SKIP + 1]
        state = [init_layer_state(l, feats.shape[0]) for l in layers]
        mesh = make_mesh(devices, tp=2)
        with jax.default_matmul_precision("highest"):
            ll_ref = np.asarray(am_forward(layers, feats, state)[0])
            with mesh:
                sh_state = [jax.tree.map(lambda a: jax.device_put(
                    a, data_sharding(mesh, a.ndim)), s) for s in state]
                ll_tp, _ = am_forward(shard_model(mesh, layers),
                                      shard_batch(mesh, feats), sh_state)
        d = float(np.abs(np.asarray(ll_tp) - ll_ref).max())
        check(d <= 1e-4, d)
        ph.note(f"dp=2 x tp=2 flagship AM {ll_ref.shape} vs one card at "
                f"highest: max|d|={d:.3g} (tol 1e-4)")
    return info


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card paths")
    args = ap.parse_args()
    import jax
    jax.monitoring.register_event_duration_secs_listener(_on_compile_event)
    info = run_four_cards(args.seed) if args.four else run_one_card(args.seed)
    print(json.dumps({"ok": True, "device": info}))


if __name__ == "__main__":
    main()
