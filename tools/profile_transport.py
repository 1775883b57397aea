"""Profile the transport round body on the GPU and list its largest device ops.

    python tools/profile_transport.py [OUT_DIR]

Runs one 64-round ``transport.transport_rounds`` call on bench.py's headline
frame (2-D cylindrical, 160x512 cells, ~1M photons, Stokes on) under
``jax.profiler.trace``, after a warm-up call, and reduces the trace to the
device time of each operation.  Prints the five largest operations, the
device busy share of the traced window and ns/photon-round from the trace,
and writes the reduction to OUT_DIR/profile_transport.json next to the raw
trace (default OUT_DIR: chiprun_out).  Then times the same call with each
PRNG implementation (rbg, threefry2x32) in alternating order, untraced.
"""
from __future__ import annotations

import glob
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def device_op_times(xplane_path: str, plane_name: str = "/device:GPU:0",
                    line_prefixes=("XLA Ops",)) -> dict:
    """Per-operation device time from one ``.xplane.pb`` trace.

    Sums the durations of the events on the lines of ``plane_name`` whose
    names start with one of ``line_prefixes`` (if none does, every line of
    the plane counts).  Busy time is the union of those events' intervals;
    the window runs from the first event's start to the last one's end.
    """
    from jax.profiler import ProfileData

    data = ProfileData.from_file(xplane_path)
    plane = data.find_plane_with_name(plane_name) or next(
        (p for p in data.planes if p.name.startswith(plane_name)), None)
    if plane is None:
        raise ValueError(f"no plane {plane_name!r} in {xplane_path}: "
                         f"{[p.name for p in data.planes]}")
    lines = list(plane.lines)
    chosen = [ln for ln in lines if ln.name.startswith(tuple(line_prefixes))] or lines
    totals, spans = {}, []
    for ln in chosen:
        for ev in ln.events:
            t, n = totals.get(ev.name, (0.0, 0))
            totals[ev.name] = (t + ev.duration_ns, n + 1)
            spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    if not spans:
        raise ValueError(f"no events on {[ln.name for ln in chosen]}")
    spans.sort()
    busy, cur_lo, cur_hi = 0.0, spans[0][0], spans[0][1]
    for lo, hi in spans[1:]:
        if lo > cur_hi:
            busy += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    busy += cur_hi - cur_lo
    ops = sorted(
        ({"name": k, "total_ns": t, "count": n} for k, (t, n) in totals.items()),
        key=lambda o: -o["total_ns"],
    )
    return dict(
        lines=[ln.name for ln in chosen], ops=ops, busy_ns=busy,
        window_ns=spans[-1][1] - spans[0][0],
        op_total_ns=sum(o["total_ns"] for o in ops),
    )


def main(out_dir: str = "chiprun_out") -> None:
    import jax
    import jax.numpy as jnp

    import chip_smoke
    from mcrat_tpu import transport
    from mcrat_tpu.ops.rng import make_key
    from mcrat_tpu.runtime import card_info, enable_compile_cache, require_gpu

    require_gpu(1)
    enable_compile_cache()
    cfg = chip_smoke.headline_config()
    host, idx, arrays = chip_smoke.headline_problem(cfg, *chip_smoke.HEADLINE_N, seed=0)
    photons, _ = transport.photons_from_arrays(arrays, capacity=None, dtype="float32")
    frame = host.to_device(dtype="float32")
    t_rem = transport.frame_time(photons, jnp.float32(0.2))

    def call(seed, impl=None):
        res = transport.transport_rounds(cfg, photons, frame, idx, t_rem,
                                         make_key(seed, impl), max_rounds=64)
        jax.block_until_ready(res.photons.p)
        return res

    call(0)
    trace_dir = os.path.join(out_dir, "trace_transport")
    t0 = time.perf_counter()
    with jax.profiler.trace(trace_dir):
        res = call(1)
    wall = time.perf_counter() - t0
    path = sorted(glob.glob(os.path.join(trace_dir, "plugins", "profile", "*",
                                         "*.xplane.pb")))[-1]
    red = device_op_times(path)
    n, rounds = photons.capacity, int(res.n_rounds)
    # PRNG implementations, alternating ABBA so drift hits both alike
    impls = ("rbg", "threefry2x32")
    times = {i: [] for i in impls}
    for i in impls:
        call(0, i)
    for k in range(4):
        for i in (impls if k % 2 == 0 else impls[::-1]):
            t0 = time.perf_counter()
            r = call(10 + k, i)
            times[i].append(1e9 * (time.perf_counter() - t0) / (n * int(r.n_rounds)))
    summary = dict(
        card=card_info(), device_kind=jax.devices()[0].device_kind,
        rng_ns_per_photon_round={i: sorted(v) for i, v in times.items()},
        n_photons=n, rounds=rounds, traced_wall_s=wall,
        busy_share=red["busy_ns"] / red["window_ns"],
        ns_per_photon_round_device=red["busy_ns"] / (n * rounds),
        lines=red["lines"], n_ops=len(red["ops"]), top_ops=red["ops"][:25],
    )
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile_transport.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(f"card: {summary['card']}")
    print(f"profile: {n} photons x {rounds} rounds; device busy "
          f"{red['busy_ns'] / 1e6:.3f} ms of a {red['window_ns'] / 1e6:.3f} ms "
          f"window ({summary['busy_share']:.3f}); "
          f"{summary['ns_per_photon_round_device']:.4f} ns/photon-round busy; "
          f"lines {red['lines']}")
    for i, v in summary["rng_ns_per_photon_round"].items():
        print(f"rng {i}: ns/photon-round (wall, 64-round call) {v}")
    for o in red["ops"][:5]:
        print(f"  {o['total_ns'] / 1e6:9.3f} ms  {o['total_ns'] / red['op_total_ns']:6.1%}"
              f"  x{o['count']:<5d} {o['name'][:120]}")


if __name__ == "__main__":
    main(*sys.argv[1:])
