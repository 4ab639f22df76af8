"""Profile the production search point op by op on the GPU.

Builds (and caches under ``build/perf/``) the composed production TLG of
``bench.py``, traces one ``search.advance`` with the JAX profiler, and
prints the top device ops by total time on each GPU plane of the trace.

    python tools/perf/profile_production.py
    python tools/perf/profile_production.py --report DIR

``--report`` only reduces an existing trace directory, e.g. one written by
``python bench.py --profile-dir=DIR``.
"""

from __future__ import annotations

import glob
import pickle
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "build" / "perf"


def load_production_graph():
    """(DeviceFst, ilabel2pdf, lexicon) of the production TLG, cached."""
    from asr_decoder_tpu.eval import operating_points as op
    from asr_decoder_tpu.fst.device_fst import DeviceFst

    cache = OUT / "tlg_graph_cache.pkl"
    if cache.exists():
        with open(cache, "rb") as f:
            return pickle.load(f)
    fst, i2p, lexicon = op.production_tlg()
    dev = DeviceFst.build(fst, arc_lanes=op.production_config().arc_lanes)
    dev.build_closure()
    OUT.mkdir(parents=True, exist_ok=True)
    with open(cache, "wb") as f:
        pickle.dump((dev, i2p, lexicon), f)
    return dev, i2p, lexicon


def device_op_times(trace_dir) -> dict:
    """{(plane, line): {event name: total ns}} over the GPU device planes
    of the newest ``.xplane.pb`` under ``trace_dir``."""
    from jax.profiler import ProfileData
    files = sorted(glob.glob(f"{trace_dir}/**/*.xplane.pb", recursive=True))
    assert files, f"no trace under {trace_dir}"
    out: dict = {}
    for plane in ProfileData.from_file(files[-1]).planes:
        if not plane.name.startswith("/device:GPU:"):
            continue
        for line in plane.lines:
            tot: dict = defaultdict(float)
            for ev in line.events:
                tot[ev.name] += ev.duration_ns
            out[(plane.name, line.name)] = dict(tot)
    return out


def report(trace_dir, top: int = 30) -> None:
    times = device_op_times(trace_dir)
    assert times, f"no GPU device plane in the trace under {trace_dir}"
    for (plane, line), tot in times.items():
        print(f"\n{plane} / {line}: {sum(tot.values()) / 1e6:.3f} ms in "
              f"{len(tot)} distinct events")
        for name, ns in sorted(tot.items(), key=lambda kv: -kv[1])[:top]:
            print(f"{ns / 1e6:9.3f} ms  {name[:110]}")


def main() -> None:
    import jax
    import jax.numpy as jnp

    from asr_decoder_tpu.eval import operating_points as op
    from asr_decoder_tpu.models.nnet import pack_nonblank_frames
    from asr_decoder_tpu.ops.beamsearch import TpuBeamSearch
    from asr_decoder_tpu.utils.device import (enable_compile_cache,
                                              require_gpu)

    require_gpu()
    enable_compile_cache()
    dev, i2p, lexicon = load_production_graph()
    search = TpuBeamSearch(dev, i2p, op.production_config())
    raw = op.tlg_posteriors(np.random.default_rng(2), lexicon,
                            op.PRODUCTION_PHONES, 32, 264)
    packed, mask = pack_nonblank_frames(raw, 0, thresh=float(np.log(0.75)))
    ll, mask = jnp.asarray(packed), jnp.asarray(mask)
    st, _ = search.init_state(ll.shape[0])

    def run():
        return jax.block_until_ready(search.advance(st, ll, mask)[0])

    run()
    t0 = time.perf_counter()
    run()
    wall = time.perf_counter() - t0
    print(f"advance {wall * 1e3:.1f} ms ({wall / ll.shape[1] * 1e3:.2f} "
          f"ms/frame)", file=sys.stderr)
    trace_dir = OUT / "tlg_trace"
    with jax.profiler.trace(str(trace_dir)):
        run()
    report(trace_dir)


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    if "--report" in sys.argv:
        report(sys.argv[sys.argv.index("--report") + 1])
    else:
        main()
