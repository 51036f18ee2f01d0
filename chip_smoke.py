"""End-to-end smoke test of nbx on an NVIDIA GPU.

    python chip_smoke.py            # one card: phases 1-6 below
    python chip_smoke.py --cards 4  # four cards: the sharded paths only

One card drives the main path through the entry points a user calls:

  1. device: the card's name and power limit, JAX's device kind/version;
  2. the reference scene with full physics (Simulation + sim.run, 300
     frames, render to PNG), its first 10 frames against the same run on
     the CPU in this process;
  3. direct-sum gravity at N = 262,144 through sim.gravity (the compiled
     Triton kernel), checked on 1,024 targets against a float64 direct sum
     on the host; then 3 frames of sim.run at that capacity;
  4. the granular full-event step at N = 131,072 with serve --big's
     settings, 10 steps; one collision pass against the plain XLA sweep
     and the XLA binned resolver;
  5. the live server (serve.serve, big mode, 131,072 bodies) answering
     /state, /frame.png, /spawn and /set over HTTP;
  6. the on-card tests: pytest -m gpu tests/test_gpu.py.

--cards 4 runs the all-gather sharded KDK step on the 1M galaxy merger and
the sharded granular step on 4 x 131,072 bodies, each against the same
steps on one card.

Each phase prints one line of findings with its measured error beside its
tolerance; any failure ends the script with a non-zero exit code and no
result line. Without a GPU it fails at once. The last line of a passing run
is {"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import struct
import subprocess
import sys
import threading
import time
import urllib.request
import zlib

ROOT = os.path.dirname(os.path.abspath(__file__))


def say(phase: str, **kw):
    print(f"[{phase}] " + json.dumps(kw, default=float), flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def median_ms(fn, *args, reps=5):
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts) * 1e3


def decode_png(data: bytes):
    """(width, height) of an 8-bit RGB/RGBA PNG whose pixel data inflates
    to the size its header states; raises otherwise."""
    check(data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG signature")
    pos, idat, w = 8, b"", None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if kind == b"IHDR":
            w, h, depth, color = struct.unpack(">IIBB", body[:10])
            check(depth == 8 and color in (2, 6), "unexpected PNG format")
            chans = 3 if color == 2 else 4
        elif kind == b"IDAT":
            idat += body
        pos += 12 + length
    check(w is not None, "PNG without IHDR")
    check(len(zlib.decompress(idat)) == h * (1 + w * chans),
          "PNG pixel data has the wrong size")
    return w, h


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip()


def f64_acc(pos, mass, targets, G, eps, chunk=64):
    import numpy as np

    p = np.asarray(pos, np.float64)
    m = np.asarray(mass, np.float64)
    out = []
    for i in range(0, len(targets), chunk):
        t = p[targets[i:i + chunk]]
        d = p[None, :, :] - t[:, None, :]
        r2 = (d * d).sum(-1) + eps * eps
        out.append(G * np.einsum("ij,ijc->ic", m[None] * r2 ** -1.5, d))
    return np.concatenate(out)


# ---------------------------------------------------------------------------
def phase_reference_scene(out_dir):
    import jax
    import numpy as np

    from nbx import sim
    from nbx.config import SimConfig
    from nbx.interactive import Simulation
    from nbx.render.viewer import png_bytes

    s = Simulation(SimConfig(), scenario="galaxy")
    cfg, st0 = s.cfg, s.state
    track = lambda st, cfg: st.pos  # noqa: E731
    cpu = jax.devices("cpu")[0]
    with jax.default_matmul_precision("highest"):
        _, pos_gpu = sim.run(st0, cfg, 10, diagnostics=track)
        st_c, cfg_c = jax.device_put((st0, cfg), cpu)
        with jax.default_device(cpu):
            _, pos_cpu = sim.run(st_c, cfg_c, 10, diagnostics=track)
    pos_gpu, pos_cpu = np.asarray(pos_gpu), np.asarray(pos_cpu)
    err = float(np.abs(pos_gpu - pos_cpu).max() / np.abs(pos_cpu).max())
    check(err <= 1e-4, f"GPU vs CPU first 10 frames: {err} > 1e-4")

    run300 = jax.jit(lambda st: sim.run(st, cfg, 300))
    st, ev = jax.block_until_ready(run300(st0))
    ms = median_ms(run300, st0, reps=3) / 300
    counts = {k: int(np.asarray(getattr(ev, k)).sum())
              for k in ("n_bounces", "n_merges", "n_fractures")}
    check(np.isfinite(np.asarray(st.pos)).all(), "non-finite state")
    check(counts["n_bounces"] + counts["n_merges"] > 0, "no events fired")
    s.state = st
    png = png_bytes(s.render())
    w, h = decode_png(png)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "galaxy_300.png"), "wb") as f:
        f.write(png)
    say("reference_scene", frames=300, bodies=cfg.capacity,
        ms_per_frame=ms, events=counts, alive=int(st.n_alive),
        png=[w, h], cpu_vs_gpu_10_frames_rel_err=err, tolerance=1e-4)


def phase_direct_gravity(n=262144):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from nbx import scene, sim
    from nbx.config import SimConfig

    G, eps = 0.5, 0.5
    sc = scene.cold_collapse_disk(n=n, seed=0)
    pos, mass = jnp.asarray(sc["pos"]), jnp.asarray(sc["mass"])
    grav = jax.jit(lambda p, m: sim.gravity(p, m, G, eps, impl="auto"))
    hlo = grav.lower(pos, mass).as_text()
    check("__gpu$xla.gpu.triton" in hlo and "nbx_gravity" in hlo,
          "sim.gravity(auto) did not reach the compiled Triton kernel")
    acc = np.asarray(grav(pos, mass))
    ms = median_ms(grav, pos, mass)
    idx = np.random.default_rng(0).choice(n, 1024, replace=False)
    ref = f64_acc(sc["pos"], sc["mass"], idx, G, eps)
    err = float(np.abs(acc[idx] - ref).max() / np.abs(ref).max())
    check(err <= 1e-5, f"gravity kernel vs float64: {err} > 1e-5")

    cfg = SimConfig(G=G, softening=eps, capacity=n, collisions=False)
    st = scene.make_state(cfg, sc)
    run3 = jax.jit(lambda st: sim.run(st, cfg, 3))
    st3, _ = jax.block_until_ready(run3(st))
    check(np.isfinite(np.asarray(st3.pos)).all(), "non-finite after 3 frames")
    frame_ms = median_ms(run3, st, reps=3) / 3
    say("direct_gravity", n=n, ms_per_eval=ms,
        pairs_per_s=n * n / (ms * 1e-3), ms_per_frame=frame_ms,
        sub_steps=cfg.sub_steps, f64_rel_err_1024_targets=err,
        tolerance=1e-5)


def _granular_scene(n):
    from nbx.bench.granular import BOX, granular_cloud
    from nbx.config import SimConfig

    box = BOX * (n / 131072.0) ** (1.0 / 3.0)
    pos, vel, mass = granular_cloud(n, box=box)
    cfg = SimConfig(G=0.5, dt=0.016, sub_steps=1, merge_time=0.25,
                    fracture_threshold=8.0)
    return box, pos, vel, mass, cfg


def phase_granular(n=131072, g=40, band=12):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from nbx.bench.kernels import gpu_choice
    from nbx.collisions_binned import resolve_bounces_binned
    from nbx.collisions_scaled import (granular_full_kdk_scan,
                                       make_granular_state)
    from nbx.config import body_radius
    from nbx.ops.collide import binned_collision_pass, bucketed_layout_for
    from nbx.ops.pm import isolated_green_hat

    box, pos, vel, mass, cfg = _granular_scene(n)
    st = make_granular_state(pos, vel, mass, key=0)
    buckets = bucketed_layout_for(st.pos, box, g, band)
    green = isolated_green_hat(box, 64)
    run10 = jax.jit(lambda st: granular_full_kdk_scan(
        st, cfg, box, n_steps=10, n_cells=g, band_cells=band,
        buckets=buckets, force_impl="pm", pm_grid=64, green_hat=green))
    st10, tot = jax.block_until_ready(run10(st))
    tot = {k: int(v) for k, v in tot.items()}
    check(tot["n_overflow"] == 0, f"n_overflow {tot['n_overflow']}")
    check(tot["n_bounces"] > 0, "no bounces")
    check(np.isfinite(np.asarray(st10.pos)).all()
          and np.isfinite(np.asarray(st10.vel)).all(), "non-finite state")
    step_ms = median_ms(run10, st, reps=3) / 10

    p, v, m = st.pos, st.vel, st.mass
    r = body_radius(m, st.mat, cfg.materials)

    def one_pass(p, v, m, r):
        return binned_collision_pass(p, v, m, r, box, g, cfg.restitution,
                                     cfg.friction, band_cells=band,
                                     buckets=buckets)

    kern = jax.jit(one_pass)
    check("nbx_collide" in kern.lower(p, v, m, r).as_text(),
          "the collision pass did not reach the Triton kernel")
    out_k = jax.block_until_ready(kern(p, v, m, r))
    with gpu_choice("collide", "xla"):
        xla = jax.jit(one_pass).lower(p, v, m, r).compile()
    out_x = jax.block_until_ready(xla(p, v, m, r))
    kern_ms, xla_ms = median_ms(kern, p, v, m, r), median_ms(xla, p, v, m, r)
    dv_k, dp_k, _, best_k, nb_k, _, _ = out_k
    dv_x, dp_x, _, best_x, nb_x, _, _ = out_x
    np.testing.assert_allclose(np.asarray(dv_k), np.asarray(dv_x),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(dp_k), np.asarray(dp_x),
                               rtol=1e-5, atol=1e-6)
    check(int(nb_k) == int(nb_x) > 0, f"bounces {int(nb_k)} vs {int(nb_x)}")
    # partners identical except between candidates of equal depth
    jk, jx = np.asarray(best_k["j"]), np.asarray(best_x["j"])
    diff = np.nonzero(jk != jx)[0]
    pn, rn = np.asarray(p), np.asarray(r)

    def depth(i, j):
        return rn[i] + rn[j] - np.linalg.norm(pn[i] - pn[j])

    for i in diff:
        check(jk[i] >= 0 and jx[i] >= 0
              and abs(depth(i, jk[i]) - depth(i, jx[i])) <= 1e-6,
              f"partner of {i}: {jk[i]} vs {jx[i]}")
    dvk = np.asarray(dv_k)
    err_x = float(np.abs(dvk - np.asarray(dv_x)).max()
                  / max(np.abs(dvk).max(), 1e-30))

    with jax.default_matmul_precision("highest"):
        dp_b, dv_b, _, nb_b, ovf_b, _ = jax.block_until_ready(
            resolve_bounces_binned(p, v, m, r, box, g, cfg.restitution,
                                   cfg.friction, max_per_cell=32))
    check(int(ovf_b) == 0, "binned resolver overflowed")
    check(int(nb_b) == int(nb_k), f"bounces {int(nb_k)} vs binned {int(nb_b)}")
    np.testing.assert_allclose(dvk, np.asarray(dv_b), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(dp_k), np.asarray(dp_b),
                               rtol=1e-5, atol=1e-6)
    err_b = float(np.abs(dvk - np.asarray(dv_b)).max()
                  / max(np.abs(dvk).max(), 1e-30))
    say("granular", n=n, n_cells=g, band_cells=band, buckets=buckets,
        steps=10, ms_per_step=step_ms, totals=tot,
        pass_ms_kernel=kern_ms, pass_ms_xla=xla_ms,
        dv_rel_err_vs_xla=err_x, dv_rel_err_vs_binned=err_b,
        partner_mismatches=int(len(diff)),
        tolerance="rtol 1e-5, atol 1e-6")


def phase_live_server(n=131072):
    from nbx.serve import serve

    httpd, live = serve(port=0, big_n=n, block=False)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def get(path):
        with urllib.request.urlopen(base + path, timeout=120) as resp:
            return resp.status, resp.read(), resp.headers.get("Content-Type")

    try:
        t0 = time.time()
        while not live.frame_png and live.error is None:
            check(time.time() - t0 < 600, "no frame within 600 s")
            time.sleep(0.2)
        check(live.error is None, f"server loop failed: {live.error}")
        code, body, _ = get("/state")
        s0 = json.loads(body)
        check(code == 200 and s0["alive"] > 0, f"bad /state {s0}")
        code, png, ctype = get("/frame.png")
        check(code == 200 and ctype == "image/png", "bad /frame.png")
        w, h = decode_png(png)
        code, body, _ = get("/spawn?sx0=300&sy0=180&sx1=330&sy1=200")
        check(code == 200 and json.loads(body)["spawned"] in (0, 1),
              "bad /spawn")
        code, body, _ = get("/set?G=0.6")
        check(code == 200 and abs(float(live.cfg.G) - 0.6) < 1e-6,
              "bad /set")
        # client-side frame rate: distinct frames seen over a window
        seen, lat = set(), []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 5.0:
            t1 = time.perf_counter()
            seen.add(zlib.crc32(get("/frame.png")[1]))
            lat.append(time.perf_counter() - t1)
        span = time.perf_counter() - t0
        s1 = json.loads(get("/state")[1])
        check(s1["step"] > s0["step"] and s1["error"] is None,
              f"server did not advance: {s0} -> {s1}")
        say("live_server", n=n, png=[w, h],
            client_ms_per_frame=span / max(len(seen), 1) * 1e3,
            frame_request_ms_median=statistics.median(lat) * 1e3,
            steps_seen=s1["step"] - s0["step"])
    finally:
        httpd.shutdown()
        live.stop()


def phase_gpu_tests():
    import pytest

    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests", "test_gpu.py")])
    check(rc == 0, f"pytest -m gpu failed with {rc}")
    say("gpu_tests", rc=int(rc))


# ---------------------------------------------------------------------------
def phase_sharded_gravity(n=1_048_576):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from nbx import scene, sim
    from nbx.parallel import shard

    G, eps, h = 0.5, 0.5, 0.01
    sc = scene.galaxy_merger(n=n, seed=0)
    mesh = shard.make_mesh(4)
    st = shard.shard_state(mesh, sc["pos"], sc["vel"], sc["mass"])
    step = shard.make_sharded_step(mesh)
    check("nbx_gravity" in step.lower(st, G, eps, h).as_text(),
          "the sharded step did not reach the gravity kernel")
    for _ in range(2):
        st = step(st, G, eps, h)
    pos_s = np.asarray(st.pos)
    t_shard = median_ms(lambda s: step(s, G, eps, h), st, reps=3)

    @jax.jit
    def kdk(pos, vel, acc, mass):
        vel = vel + acc * (0.5 * h)
        pos = pos + vel * h
        acc = sim.gravity(pos, mass, G, eps)
        return pos, vel + acc * (0.5 * h), acc

    one = jax.devices()[0]
    pos, vel, mass = (jax.device_put(jnp.asarray(sc[k]), one)
                      for k in ("pos", "vel", "mass"))
    acc = jnp.zeros_like(pos)
    for _ in range(2):
        pos, vel, acc = kdk(pos, vel, acc, mass)
    pos1 = np.asarray(pos)
    t_one = median_ms(kdk, pos, vel, acc, mass, reps=3)
    err = float(np.abs(pos_s - pos1).max() / np.abs(pos1).max())
    check(err <= 1e-5, f"sharded vs one card: {err} > 1e-5")
    say("sharded_gravity", n=n, cards=4, ms_per_step_4_cards=t_shard,
        ms_per_step_1_card=t_one, rel_err_vs_1_card=err, tolerance=1e-5)


def phase_sharded_granular(n_per_card=131072, g=64, band=12):
    import jax
    import numpy as np

    from nbx.collisions_scaled import (granular_full_kdk_scan,
                                       make_granular_state)
    from nbx.ops.collide import packed_caps_for
    from nbx.parallel import shard

    n = 4 * n_per_card
    box, pos, vel, mass, cfg = _granular_scene(n)
    caps = packed_caps_for(pos, box, g, band)
    mesh = shard.make_mesh(4)
    step = shard.make_sharded_granular_step(mesh, cfg, box, g, band, caps,
                                            force_impl="zero")
    stb = shard.shard_body_state(mesh, pos, vel, mass)
    key = jax.random.PRNGKey(0)
    stb, c = jax.block_until_ready(step(stb, cfg.dt, key))
    c = {k: int(v) for k, v in c.items()}
    t_shard = median_ms(lambda s: step(s, cfg.dt, key), stb, reps=3)

    one = jax.jit(lambda st: granular_full_kdk_scan(
        st, cfg, box, n_steps=1, n_cells=g, band_cells=band,
        packed_caps=caps, force_impl="zero"))
    st1 = make_granular_state(pos, vel, mass, key=0)
    st1n, tot = jax.block_until_ready(one(st1))
    tot = {k: int(v) for k, v in tot.items()}
    t_one = median_ms(one, st1, reps=3)
    check(c["n_overflow"] == 0 and tot["n_overflow"] == 0, "overflow")
    check(c["n_bounces"] == tot["n_bounces"] > 0,
          f"bounces {c['n_bounces']} vs one card {tot['n_bounces']}")
    check(np.isfinite(np.asarray(stb.pos)).all(), "non-finite state")
    say("sharded_granular", n=n, cards=4, n_cells=g, band_cells=band,
        packed_caps=caps, bounces_4_cards=c["n_bounces"],
        bounces_1_card=tot["n_bounces"], ms_per_step_4_cards=t_shard,
        ms_per_step_1_card=t_one)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4))
    ap.add_argument("--out", default=os.path.join(ROOT, "smoke_out"),
                    help="directory for the rendered PNG")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {devs[0].platform}",
              file=sys.stderr)
        return 2
    if len(devs) < args.cards:
        print(f"chip_smoke: needs {args.cards} GPUs; found {len(devs)}",
              file=sys.stderr)
        return 2
    from nbx.backend import enable_compile_cache

    cache = enable_compile_cache()
    card = card_line()
    say("device", nvidia_smi=card, kind=devs[0].device_kind,
        count=len(devs), jax=jax.__version__, compile_cache=cache)
    if args.cards == 4:
        phases = [phase_sharded_gravity, phase_sharded_granular]
    else:
        phases = [lambda: phase_reference_scene(args.out),
                  phase_direct_gravity, phase_granular, phase_live_server,
                  phase_gpu_tests]
    for phase in phases:
        t0 = time.perf_counter()
        phase()
        print(f"  ({time.perf_counter() - t0:.1f} s)", flush=True)
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
