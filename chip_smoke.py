"""Smoke run of the PyTorch/CUDA port (craytpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. build   — nvcc builds both kernels from craytpu_torch/csrc (in
               parallel) into build/craytpu_torch/, and prints each
               kernel's registers a thread, stack frame and spill bytes
               (local memory) and static shared memory, as ptxas -v
               reported them, and its static SASS instruction count.
  2. kernels — each kernel's wrapper on CUDA tensors at a shape the
               render gives it, against its plain PyTorch version on CPU
               copies of the same inputs: bit-equal (NaN == NaN). Also
               times the kernel and the plain version (on the card) with
               CUDA events, and works out the kernel's bound.
               K1 (hit records): 2^20 random winner ids (a first-bounce
               batch); K2 (closest hit): 2^16 rays of stress_highpoly,
               half primary, half random (a compacted bucket), and the
               1080p frame's first 2^20-lane primary batch, timed whole
               and checked on every 16th lane (rays are independent).
  3. golden  — stress_highpoly and stress_instances at 80x50, 4 spp,
               through the kernels, against goldens/*_80_4.png at the
               thresholds of craytpu_torch/utils/golden.py.
  4. render  — the main path at full width: Renderer.load_scene_from_file
               -> start_renderer -> write_image on
               assets/stress_highpoly.json at 1920x1080, its own 12
               bounces, 4 spp, after one warm-up pass. Launch counters
               are set to 0 just before and read just after; both kernels
               must have launched. Prints paths/s, peak device memory,
               and, over two more frames, each kernel's launches and time
               per frame (CUDA events around each launch), its time per
               launch grouped by batch size, and the frame's device-time
               breakdown (torch.profiler).
  5. persistent — the CLI's path (make_renderer -> render_persistent):
               both stress goldens at 80x50, 4 spp; an interrupt at the
               3rd poll, a checkpoint on disk and a resume at 96x64 on
               assets/entry_scene.json against the uninterrupted render
               (rtol=2e-5, atol=2e-6); `python3 -m craytpu_torch
               assets/stress_highpoly.json -s 4 -d 1920x1080` as a
               subprocess (exit 0, a 1920x1080 PNG under build/); one
               persistent 1080p frame with the launch counters set to 0
               just before and read just after (both kernels must have
               launched), its pool steps, refills, shrinks and peak
               device memory; paths/s of per-pass and persistent frames
               taken in turns (per-pass, persistent, persistent,
               per-pass, three rounds: median and range); and the same
               kernel-time breakdown as phase 4 for a persistent frame.
  6. grad    — the differentiable trace at full width: the first 2^20
               pixels of the 1080p stress_highpoly frame (tile order),
               pass 0 of 4, 12 bounces, census_schedule(passes=[0],
               safety=1.05, quant=1024, shrink_ratio=0.5) and
               make_trace_fn(remat="segment_hits", compaction=schedule,
               sort="boundary"); loss = mean(img[..., :3]) and its gradient
               with respect to every ShadeParams table. Prints the
               schedule, fwd+bwd paths/s (2 timed runs after a warm-up),
               peak device memory, K2 and K1 launches and device ms per
               fwd+bwd and the device busy share (torch.profiler); then
               the same with diff_geometry=True (gradient into tri_packed).
               Fails unless (a) the forward image equals trace_batch of
               the same lanes (rtol=2e-5, atol=2e-6) and every gradient
               is finite, colors and emission non-zero; (b) on 2^16 lanes
               the compacted trace gives the plain trace's image (rtol=
               2e-5, atol=2e-6) and gradients (rtol=2e-4, atol=1e-6),
               launching K2 in fwd+bwd as often as in the forward alone;
               (c) gradients match finite differences: colors and
               emission on tests/test_grad.py's scene, vertices on
               tests/test_vertex_grad.py's flat cube.
  7. nee     — next-event estimation: on tests/test_nee.py's scene the
               persistent pool, the per-pass render and the summed
               make_trace_fn(nee=True) passes agree (rtol=2e-5,
               atol=2e-6) and the NEE gradient of the emitter's emission
               matches FD (rtol=2e-3); a persistent 1080p stress_highpoly
               frame with NEE: launches, peak memory, and paths/s in
               turns with the frame without NEE; and `python3 -m
               craytpu_torch assets/stress_highpoly.json -s 4 -d
               1920x1080 --nee` (exit 0, a 1920x1080 PNG).
  8. edge    — edge-aware silhouette gradients and the inverse-rendering
               train step. Finite differences on the scenes of
               tests/test_edge_grad.py (32x24, 48 passes, 64 samples an
               edge, h=0.04) and tests/test_edge_occluder.py (64x48, 32
               passes, h=0.05), each over fresh compile_scene calls of
               the moved vertex: fails unless AD with the boundary term
               (make_edge_grad_fn) is within rtol 0.3 of FD with its sign
               and the interior estimator alone misses FD by more than
               0.5 |FD|. The secondary term (make_edge_grad2_fn) on
               tests/test_edge_secondary.py's scene (32x24, 24 passes,
               h=0.1): AD, FD and their ratio, which must be finite.
               Then parallel/shard.py::make_train_step on the first 2^20
               pixels of the 1080p stress_highpoly frame, 12 bounces,
               target 0.8 x a render of them: a geometry step
               (edge_samples=32) and a material step, each timed as the
               mean of 2 after a warm-up (synchronised through the loss),
               with its peak device memory, K2/K1 launches (counts set to
               0 just before one step and read just after) and moved
               tables; for the geometry step also the boundary backward's
               time (synchronised around it) and launches, its silhouette
               samples of E x S and side rays, the tri_packed rows moved,
               and a profiled step.
  9. cluster — the TCP cluster on this card: `python3 -m craytpu_torch
               --worker <free port>` as a subprocess (killed in a finally);
               both stress goldens at 80x50, 4 spp, through
               render_clustered with the master and the worker; then
               stress_highpoly at 1920x1080, its 64x64 tiles and 12
               bounces, one session: one tile pass is timed first and the
               largest spp of {4, 2, 1} whose frames fit about 100 s is
               run, the master alone (clients=[]) and master + worker in
               turns; each frame equal to render_pass's (rtol=2e-6,
               atol=2e-7); paths/s, tiles done by each side, the worker's
               ms a tile from its stats push, the K2/K1 launches of the
               first master-alone frame (counts set to 0 just before, read
               just after), the persistent frame's paths/s for scale; last,
               `python3 -m craytpu_torch --shutdown --nodes` and the worker
               exits 0 within 30 s.
  10. tools  — at 1920x1080 on stress_highpoly, 4 spp: the persistent
               frame with a PreviewServer (ephemeral port) fed through
               on_frame, in turns with the frame without it, status.json
               and frame.png fetched during the render (the PNG decodes to
               1080x1920); the CLI with --trace in a subprocess (the trace
               names closest_hit_kernel and hitrec_kernel; its size and the
               CLI's wall time); CRAYTPU_DEBUG=1: the clean per-pass frame
               bit-equal to the frame without it, the persistent frame
               within rtol=2e-5, atol=2e-6 (values that differ reported),
               their times, a NaN albedo and an out-of-range id raise;
               CRAYTPU_POOL_STATS=1: the step, refill and shrink counts
               equal phase 5's, and with CRAYTPU_POOL_SYNC=1 each phase's
               wall time; `--test-perf` prints its five lines and
               `--tcount` a positive count.
Then one line {"kernels": [...]} and, last, the ok line with the device.
Needs one CUDA card; exits 1 without one.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
# H100 SXM peaks (NVIDIA data sheet): HBM3 rate and non-tensor f32 rate
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# f32 operations (mul/add/sub/div/sqrt, counted from csrc/detmath.cuh and
# the kernels) per unit of work: K2 per inner-node visit (two slab tests),
# per triangle test, per sphere test (with its instance transform); K1 per
# lane (the whole record)
K2_OPS_INNER, K2_OPS_TRI, K2_OPS_SPHERE = 24, 311, 619
K1_OPS_LANE = 1851
# K1 bytes per lane: 7 ray floats and 2 ids in, 16 record floats out; the
# tri_wide (32-float) and inst_wide (28-float) rows count once per row read
K1_BYTES_LANE = (7 + 2 + 16) * 4
K1_BYTES_TRI_ROW, K1_BYTES_INST_ROW = 32 * 4, 28 * 4
# the main path's frame
W, H, SPP = 1920, 1080, 4


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        fail(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def bit_diff(got, want, name: str) -> float:
    """Fail unless float tensors are bit-equal (NaN == NaN). Returns the
    largest |got - want| over finite entries (0.0 when equal)."""
    g = np.ascontiguousarray(got.cpu().numpy())
    w = np.ascontiguousarray(want.cpu().numpy())
    if g.shape != w.shape or g.dtype != w.dtype:
        fail(f"{name}: {g.shape} {g.dtype} vs {w.shape} {w.dtype}")
    if g.dtype == np.float32:
        nan = np.isnan(g) & np.isnan(w)
        bad = (g.view(np.uint32) != w.view(np.uint32)) & ~nan
    else:
        bad = g != w
    fin = np.isfinite(g) & np.isfinite(w) if g.dtype == np.float32 else None
    err = float(np.max(np.abs(g[fin].astype(np.float64)
                              - w[fin].astype(np.float64)), initial=0.0)) \
        if fin is not None else float(np.max(np.abs(g - w), initial=0))
    if bad.any():
        fail(f"{name}: kernel and plain version differ in {int(bad.sum())} "
             f"of {bad.size} values (max |d| {err})")
    return err


def load(name: str, overrides: dict):
    from craytpu_torch.scene.sceneloader import load_scene_from_file
    return load_scene_from_file(os.path.join(REPO, "assets",
                                             f"{name}.json"), overrides)


# The measurement helpers below use only what every commit of the port has
# (scripts/torch_ab.py runs them on an earlier checkout's package too).

def scene_box(cs):
    bb = cs.geom.node_bounds[0].cpu().numpy()
    return bb[[0, 2, 4]], bb[[1, 3, 5]]


def mixed_rays(cs_cpu, rng, B: int = 1 << 16):
    """B rays over a 1080p frame of the scene: half primary (camera rays
    of random pixels, pass 0 of 4), half random through the scene bounds,
    every 8th lane dead (a compacted bucket). CPU tensors (o, d, limit)."""
    import torch
    from craytpu_torch.models.wavefront_pt import WavefrontRenderer
    from craytpu_torch.ops import traverse as trv
    ren = WavefrontRenderer(cs_cpu)
    width = cs_cpu.camera.width
    sel = rng.choice(width * cs_cpu.camera.height, B // 2, replace=False)
    xs = torch.from_numpy((sel % width).astype(np.int32))
    ys = torch.from_numpy((sel // width).astype(np.int32))
    o_p, d_p, _ = ren._init_rays(xs, ys, 0, SPP)
    lo, hi = scene_box(cs_cpu)
    o_r = rng.uniform(lo - 0.2 * (hi - lo), hi + 0.2 * (hi - lo),
                      (B // 2, 3)).astype(np.float32)
    d_r = rng.normal(size=(B // 2, 3)).astype(np.float32)
    d_r /= np.linalg.norm(d_r, axis=1, keepdims=True)
    o = torch.cat([o_p, torch.from_numpy(o_r)]).contiguous()
    d = torch.cat([d_p, torch.from_numpy(d_r)]).contiguous()
    limit = torch.where(torch.arange(B) % 8 == 7, 0.0, trv.FLT_MAX)
    return o, d, limit


def primary_batch(cs_dev):
    """The frame's first ray batch (2^20 lanes at 1080p, tile order,
    pass 0 of 4) on the scene's device: (o, d, limit)."""
    import torch
    from craytpu_torch.models.wavefront_pt import WavefrontRenderer
    from craytpu_torch.ops import traverse as trv
    ren = WavefrontRenderer(cs_dev)
    xs, ys, _, T = ren._pixel_schedule
    o, d, _ = ren._init_rays(xs[:T], ys[:T], 0, SPP)
    return o, d, torch.full((T,), trv.FLT_MAX, device=o.device)


def winner_ids(cs_cpu, rng, B: int = 1 << 20):
    """B random rays and winner ids, valid and -1 alike: CPU tensors
    (o, d, t_k, prim, inst)."""
    import torch
    lo, hi = scene_box(cs_cpu)
    P, I = cs_cpu.tri_wide.shape[0], cs_cpu.inst_wide.shape[0]
    o = torch.from_numpy(rng.uniform(lo, hi, (B, 3)).astype(np.float32))
    d = rng.normal(size=(B, 3)).astype(np.float32)
    d = torch.from_numpy(d / np.linalg.norm(d, axis=1, keepdims=True))
    t_k = torch.from_numpy(rng.uniform(0, 50, B).astype(np.float32))
    prim = torch.from_numpy(rng.integers(-1, P, B, dtype=np.int32))
    inst = torch.from_numpy(rng.integers(-1, I, B, dtype=np.int32))
    return o, d, t_k, prim, inst


def cuda_ms(fn, reps: int, spin: bool = True) -> float:
    """Mean device time of fn() over reps runs, by CUDA events, after one
    warm-up run. With `spin`, the runs are queued behind a 50 ms device
    spin, so that the device runs them back to back and host overhead
    between launches is not timed (unless the host needs longer than the
    spin to queue them, or fn synchronises). Without it, the events also
    count any host time a launch takes beyond the previous kernel's."""
    import torch
    fn()
    torch.cuda.synchronize()
    if spin:
        torch.cuda._sleep(100_000_000)  # about 50 ms of clock cycles
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main_path_renderer(torch):
    """A Renderer on assets/stress_highpoly.json at W x H, its own
    bounces, after one warm-up pass of 1 spp, set to SPP."""
    from craytpu_torch.api import Renderer
    r = Renderer(overrides={"width": W, "height": H, "samples": 1})
    if not r.load_scene_from_file(os.path.join(REPO, "assets",
                                               "stress_highpoly.json")):
        fail("stress_highpoly.json did not load")
    t0 = time.perf_counter()
    r.start_renderer()                       # warm-up pass (1 spp)
    torch.cuda.synchronize()
    print(f"warm-up pass: {time.perf_counter() - t0:.2f} s", flush=True)
    r.set_sample_count(SPP)
    return r


def timed_frame(torch, r) -> tuple[float, int]:
    """One frame of r through start_renderer: (paths/s over passes 2 to
    SPP, i.e. pixels x passes / their wall seconds, and the frame's peak
    device memory in bytes)."""
    marks = []

    def progress(p, spp, accum):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    torch.cuda.reset_peak_memory_stats()
    r.start_renderer(progress)
    paths_s = W * H * (SPP - 1) / (marks[-1] - marks[0])
    return paths_s, torch.cuda.max_memory_allocated()


def phase_kernels(torch) -> dict:
    from craytpu_torch.ops import hitrec as hr
    from craytpu_torch.ops import traverse as trv
    from craytpu_torch.scene.compile import compile_scene

    host = load("stress_highpoly", {"width": W, "height": H})
    cs_cpu = compile_scene(host, "cpu")
    cs_dev = compile_scene(host, "cuda")
    geom, layout = cs_dev.geom, cs_dev.layout
    rng = np.random.default_rng(20260)
    out = {}

    # ---- K2: 2^16 rays, half primary (camera rays of random pixels of the
    # frame), half random through the scene bounds; every 8th lane dead
    B2 = 1 << 16
    o, d, limit = mixed_rays(cs_cpu, rng, B2)
    args = (cs_cpu.tlas_end, cs_cpu.stack_depth)
    counts = trv.new_counts()
    t0 = time.perf_counter()
    want = trv.traverse_plain(cs_cpu.geom, o, d, limit, *args, counts)
    plain_cpu_s = time.perf_counter() - t0
    oc, dc, lc = o.cuda(), d.cuda(), limit.cuda()
    got = trv.closest_hit(geom, oc, dc, lc, *args, layout)
    torch.cuda.synchronize()
    bit_diff(got.inst, want.inst, "K2 inst")
    bit_diff(got.prim, want.prim, "K2 prim")
    err = bit_diff(got.t, want.t, "K2 t")
    hits = int((want.inst >= 0).sum())
    ms = cuda_ms(lambda: trv.closest_hit(geom, oc, dc, lc, *args, layout),
                 20)
    plain_ms = cuda_ms(lambda: trv.traverse_plain(geom, oc, dc, lc, *args),
                       1)
    ops = (K2_OPS_INNER * counts["inner"] + K2_OPS_TRI * counts["tri"]
           + K2_OPS_SPHERE * counts["sphere"])
    # bytes: each ray's 7 input and 3 output words, and once each scene
    # row this data reads: bounds, child and count (32 B) of every node
    # read, packed row (48 B) and prim_idx slot (4 B) of every triangle
    # tested
    n_nodes = int(torch.unique(torch.cat(counts["node_ids"])).numel())
    n_tris = int(torch.unique(torch.cat(counts["tri_ids"])).numel())
    nbytes = B2 * (7 + 3) * 4 + n_nodes * 32 + n_tris * (48 + 4)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    out["closest_hit"] = dict(
        name="closest_hit", ok=True, route="cuda",
        source="craytpu_torch/csrc/closest_hit.cu",
        replaces="craytpu/ops/flash2.py:185", launches=0,
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=None)
    print(f"K2 closest_hit: B={B2} hits={hits} bit-equal to the plain "
          f"version (plain on CPU {plain_cpu_s:.1f} s); work: "
          f"{counts['inner']} inner visits, {counts['tri']} triangle tests, "
          f"{counts['sphere']} sphere tests, {n_nodes} nodes and {n_tris} "
          f"triangles read -> {ops:.3e} f32 ops, {nbytes / 1e6:.2f} MB; "
          f"kernel {ms:.4f} ms, plain on card {plain_ms:.2f} ms, bound "
          f"{max(t_bytes, t_ops):.4f} ms", flush=True)

    # ---- K2 on the 1080p frame's first primary batch (pass 0 of 4):
    # timed on all 2^20 lanes, checked on every 16th lane
    o_b, d_b, lim_b = primary_batch(cs_dev)
    T = o_b.shape[0]
    got = trv.closest_hit(geom, o_b, d_b, lim_b, *args, layout)
    torch.cuda.synchronize()
    sub = torch.arange(0, T, 16, device="cuda")
    want = trv.traverse_plain(cs_cpu.geom, o_b[sub].cpu(), d_b[sub].cpu(),
                              lim_b[sub].cpu(), *args)
    bit_diff(got.inst[sub], want.inst, "K2 primary inst")
    bit_diff(got.prim[sub], want.prim, "K2 primary prim")
    bit_diff(got.t[sub], want.t, "K2 primary t")
    ms_b = cuda_ms(lambda: trv.closest_hit(geom, o_b, d_b, lim_b, *args,
                                           layout), 10)
    print(f"K2 closest_hit: primary batch B={T} (1080p, pass 0, tile "
          f"order) {ms_b:.4f} ms ({ms_b * 1e6 / T:.2f} ns a ray); every "
          f"16th lane ({sub.numel()}) bit-equal to the plain version, "
          f"{int((want.inst >= 0).sum())} hits", flush=True)

    # ---- K1: 2^20 random winner ids over the same scene
    B1 = 1 << 20
    k1_in = winner_ids(cs_cpu, rng, B1)
    prim, inst = k1_in[3], k1_in[4]
    want = hr.hitrec_record(cs_cpu.tri_wide, cs_cpu.inst_wide, *k1_in, True)
    tw, iw = cs_cpu.tri_wide.cuda(), cs_cpu.inst_wide.cuda()
    k1_dev = [x.cuda() for x in k1_in]
    got = hr.hitrec_record(tw, iw, *k1_dev, True)
    torch.cuda.synchronize()
    err = bit_diff(got, want, "K1 record")
    ms = cuda_ms(lambda: hr.hitrec_record(tw, iw, *k1_dev, True), 20)
    plain_ms = cuda_ms(lambda: hr.hitrec_plain(tw, iw, *k1_dev, True), 3)
    # each table row this data reads counts once (the kernel reads the
    # row of id 0 for a lane whose id is -1)
    n_trows = int(np.unique(np.maximum(prim.numpy(), 0)).size)
    n_irows = int(np.unique(np.maximum(inst.numpy(), 0)).size)
    nbytes = (B1 * K1_BYTES_LANE + n_trows * K1_BYTES_TRI_ROW
              + n_irows * K1_BYTES_INST_ROW)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = B1 * K1_OPS_LANE / F32_OPS_PER_S * 1e3
    out["hitrec"] = dict(
        name="hitrec", ok=True, route="cuda",
        source="craytpu_torch/csrc/hitrec.cu",
        replaces="craytpu/ops/hitrec_kernel.py:37", launches=0,
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=None)
    print(f"K1 hitrec: B={B1} bit-equal to the plain version; work: "
          f"{n_trows} tri_wide and {n_irows} inst_wide rows read, "
          f"{nbytes / 1e6:.2f} MB, {B1 * K1_OPS_LANE:.3e} f32 ops; kernel "
          f"{ms:.4f} ms, plain on card {plain_ms:.2f} ms, bound "
          f"{max(t_bytes, t_ops):.4f} ms", flush=True)
    return out


def phase_golden(torch) -> None:
    from craytpu_torch.models.wavefront_pt import render
    from craytpu_torch.ops import hitrec as hr
    from craytpu_torch.ops import traverse as trv
    from craytpu_torch.scene.compile import compile_scene
    from craytpu_torch.utils import golden

    for name in ("stress_highpoly", "stress_instances"):
        n_k2, n_k1 = trv.closest_hit.launches, hr.hitrec_record.launches
        cs = compile_scene(load(name, {"width": 80, "height": 50,
                                       "samples": 4}))
        fb = render(cs, spp=4)
        if not (trv.closest_hit.launches > n_k2
                and hr.hitrec_record.launches > n_k1):
            fail(f"golden {name}: the render did not go through the "
                 "kernels")
        ok, within, mean_abs = golden.compare(fb, name, 80, 50, 4)
        print(f"golden {name} 80x50 4spp: within1lsb={within:.5f} "
              f"mean_abs={mean_abs:.4f} ok={ok}", flush=True)
        if not ok:
            fail(f"golden {name}")


def profile_frame(torch, frame, kernels=()) -> dict:
    """One call of frame() under torch.profiler: device time per kernel
    name (ms), the whole device time, the frame's wall time, and for each
    name in `kernels` the device time of each of its launches (ms), in
    order."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        frame()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    launches = {k: [] for k in kernels}
    for ev in prof.events():
        for k in kernels:
            if ev.device_type == torch.autograd.DeviceType.CUDA \
                    and k in ev.name:
                launches[k].append((ev.time_range.start,
                                    ev.device_time_total / 1e3))
    by_name = {}
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        t_us = getattr(ev, "device_time_total",
                       getattr(ev, "cuda_time_total", 0.0))
        name, n = by_name.get(ev.key, (0.0, 0))
        by_name[ev.key] = (name + t_us / 1e3, n + ev.count)
    return {"by_name": by_name, "wall_ms": wall_ms,
            "device_ms": sum(v[0] for v in by_name.values()),
            "launches": {k: [ms for _, ms in sorted(v)]
                         for k, v in launches.items()}}


KERNEL_NAMES = {"closest_hit": "closest_hit_kernel",
                "hitrec": "hitrec_kernel"}


def print_frame_profile(torch, frame) -> None:
    """Each kernel's launches and time over one frame() (CUDA events
    around each launch, launch gaps included), then a profiled frame():
    the device time of each launch by batch size (from the launches'
    order) and the whole device-time breakdown."""
    from craytpu_torch.ops import cuda_build
    with cuda_build.launch_timing() as times:
        frame()
    with cuda_build.launch_timing() as sizes:
        prof = profile_frame(torch, frame, KERNEL_NAMES.values())
    by_name = prof["by_name"]
    for name, k in KERNEL_NAMES.items():
        ev = times.get(name, [])
        dev = prof["launches"][k]
        total = [ms for key, (ms, _) in by_name.items() if k in key]
        prof_ms = f"{sum(total):.2f} ms" if total else "not measured"
        print(f"  {name}: per frame {len(ev)} launches, "
              f"{sum(ms for _, ms in ev):.2f} ms (CUDA events; profiler: "
              f"{prof_ms}); device time per launch by batch size "
              f"(profiler):", flush=True)
        by_size: dict = {}
        for (size, _), ms in zip(sizes.get(name, []), dev):
            by_size.setdefault(size, []).append(ms)
        for size in sorted(by_size, reverse=True):
            v = by_size[size]
            print(f"    B={size:8d}: {len(v):3d}x, mean {sum(v) / len(v):.4f}"
                  f" ms, min {min(v):.4f}, max {max(v):.4f}, sum "
                  f"{sum(v):.3f}", flush=True)
    print(f"profiled frame: wall {prof['wall_ms']:.1f} ms, device busy "
          f"{prof['device_ms']:.1f} ms "
          f"({100 * prof['device_ms'] / prof['wall_ms']:.1f}%; "
          f"{len(by_name)} kernel names); top device kernels:", flush=True)
    for key, (ms, n) in sorted(by_name.items(),
                               key=lambda kv: -kv[1][0])[:12]:
        print(f"    {ms:9.2f} ms {n:6d}x  {key[:90]}", flush=True)


def phase_render(torch, kernels: dict) -> None:
    from craytpu_torch.ops import hitrec as hr
    from craytpu_torch.ops import traverse as trv

    r = main_path_renderer(torch)
    r.set_output_path(os.path.join(REPO, "build", "chip_smoke") + "/")
    trv.closest_hit.launches = 0
    hr.hitrec_record.launches = 0
    paths_s, peak = timed_frame(torch, r)
    n_k2, n_k1 = trv.closest_hit.launches, hr.hitrec_record.launches
    path = r.write_image()
    if n_k2 == 0 or n_k1 == 0:
        fail(f"main path launched closest_hit {n_k2}x, hitrec {n_k1}x")
    kernels["closest_hit"]["launches"] = n_k2
    kernels["hitrec"]["launches"] = n_k1
    fb = r.framebuffer
    if fb.shape != (H, W, 4) or not np.isfinite(fb).all():
        fail(f"frame: shape {fb.shape}, finite={np.isfinite(fb).all()}")
    if not fb[..., :3].max() > 0.0:
        fail("frame is black")
    print(f"render stress_highpoly {W}x{H} {SPP}spp "
          f"bounces={r.bounces()}: frame {r.render_time_ms / 1e3:.2f} s "
          f"(scene compile included), {paths_s:.0f} paths/s over passes "
          f"2-{SPP}; launches per frame: closest_hit {n_k2}, hitrec {n_k1}; "
          f"peak device memory {peak / 2**30:.2f} GiB; wrote {path}",
          flush=True)
    from craytpu_torch.models.wavefront_pt import WavefrontRenderer
    ren = WavefrontRenderer(r.compiled)
    print_frame_profile(torch, lambda: ren.render(SPP))


def frame_per_pass(torch, ren) -> float:
    """One per-pass frame of ren (render_pass x SPP, the frame kept on
    the card): wall seconds to the last pass's end."""
    t0 = time.perf_counter()
    accum = torch.zeros((ren.height, ren.width, 4), device=ren.device)
    for p in range(SPP):
        accum = ren.render_pass(accum, p, SPP)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def frame_persistent(torch, ren) -> float:
    """One persistent frame of ren (render_persistent, fetch=False):
    wall seconds to its end."""
    t0 = time.perf_counter()
    ren.render_persistent(SPP, fetch=False)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def count_pool_calls(ren) -> dict:
    """Count the pool steps, refills (device and host) and shrinks of ren
    by wrapping its methods on the instance (del the attributes to stop)."""
    calls = {"_pool_step": 0, "_flush_pack_refill": 0,
             "_flush_pack_refill_host": 0, "_pack_shrink": 0}

    def wrap(name):
        fn = getattr(ren, name)

        def counted(*a):
            calls[name] += 1
            return fn(*a)
        setattr(ren, name, counted)
    for name in calls:
        wrap(name)
    return calls


def phase_persistent(torch, kernels: dict) -> dict:
    """Phase 5: the CLI's path, the persistent pool, on the card. Returns
    the persistent 1080p frame's pool calls (count_pool_calls)."""
    from craytpu_torch.io.png import read_png_rgb
    from craytpu_torch.models.wavefront_pt import WavefrontRenderer
    from craytpu_torch.ops import hitrec as hr
    from craytpu_torch.ops import traverse as trv
    from craytpu_torch.parallel.pool_shard import make_renderer
    from craytpu_torch.runtime import checkpoint
    from craytpu_torch.scene.compile import compile_scene
    from craytpu_torch.utils import golden

    # ---- both stress goldens through render_persistent
    for name in ("stress_highpoly", "stress_instances"):
        n_k2, n_k1 = trv.closest_hit.launches, hr.hitrec_record.launches
        cs = compile_scene(load(name, {"width": 80, "height": 50,
                                       "samples": 4}))
        fb = make_renderer(cs).render_persistent(4)
        if not (trv.closest_hit.launches > n_k2
                and hr.hitrec_record.launches > n_k1):
            fail(f"persistent golden {name}: the render did not go "
                 "through the kernels")
        ok, within, mean_abs = golden.compare(fb, name, 80, 50, 4)
        print(f"persistent golden {name} 80x50 4spp: within1lsb="
              f"{within:.5f} mean_abs={mean_abs:.4f} ok={ok}", flush=True)
        if not ok:
            fail(f"persistent golden {name}")

    # ---- interrupt at the 3rd poll, checkpoint to disk, resume: equal to
    # the uninterrupted render up to accumulation order (index_add_'s
    # atomics), rtol=2e-5, atol=2e-6. k=1 keeps paths in flight.
    os.environ["CRAYTPU_POOL_K"] = "1"
    try:
        r = WavefrontRenderer(compile_scene(load("entry_scene", {})),
                              tile_rays=8192)
        ref = r.render_persistent(3)
        polls = []

        def interrupt():
            polls.append(1)
            return len(polls) >= 3
        out = r.render_persistent(3, interrupt=interrupt)
        if not (isinstance(out, tuple) and out[0] == "interrupted"
                and len(out[2]) > 0):
            fail("persistent interrupt: no in-flight paths checkpointed")
        path = os.path.join(REPO, "build", "chip_smoke", "entry.ckpt.npz")
        checkpoint.save_persistent(path, out[1], out[2], out[3], 3,
                                   (r.height, r.width))
        resume, total, shape = checkpoint.load_persistent(path)
        resumed = r.render_persistent(3, resume=resume)
    finally:
        del os.environ["CRAYTPU_POOL_K"]
    err = float(np.max(np.abs(resumed - ref)))
    print(f"persistent resume {r.width}x{r.height} 3spp: interrupted at "
          f"poll 3 with {len(out[2])} paths in flight; resumed vs "
          f"uninterrupted max |d| {err:.3e}", flush=True)
    if not np.allclose(resumed, ref, rtol=2e-5, atol=2e-6):
        fail("persistent resume differs from the uninterrupted render")

    # ---- the CLI at full width, as a user runs it
    cli_dir = os.path.join(REPO, "build", "chip_smoke", "cli")
    os.makedirs(cli_dir, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "craytpu_torch",
           os.path.join(REPO, "assets", "stress_highpoly.json"), "-s",
           str(SPP), "-d", f"{W}x{H}"]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=cli_dir, env=env, capture_output=True,
                         text=True, timeout=300)
    cli_s = time.perf_counter() - t0
    png = os.path.join(cli_dir, "output", "stress_highpoly_0000.png")
    if res.returncode != 0 or not os.path.exists(png):
        fail(f"CLI exited {res.returncode}: {res.stderr[-2000:]}")
    img = read_png_rgb(png)
    if img.shape != (H, W, 3) or not img.max() > 0:
        fail(f"CLI image: shape {img.shape}, max {img.max()}")
    done = [ln for ln in res.stdout.splitlines() if "Finished" in ln]
    print(f"CLI {' '.join(cmd[2:])}: exit 0 in {cli_s:.1f} s (process "
          f"start, scene load and kernel load included); "
          f"{done[-1] if done else ''}; wrote {png} {img.shape}",
          flush=True)

    # ---- the persistent 1080p frame: launches, pool calls, peak memory
    cs = compile_scene(load("stress_highpoly", {"width": W, "height": H,
                                                "samples": SPP}))
    ren = make_renderer(cs)
    frame_persistent(torch, ren)                     # warm-up
    frame_per_pass(torch, ren)
    calls = count_pool_calls(ren)
    torch.cuda.reset_peak_memory_stats()
    trv.closest_hit.launches = 0
    hr.hitrec_record.launches = 0
    fb = ren.render_persistent(SPP)
    n_k2, n_k1 = trv.closest_hit.launches, hr.hitrec_record.launches
    peak = torch.cuda.max_memory_allocated()
    for name in calls:
        delattr(ren, name)
    if n_k2 == 0 or n_k1 == 0:
        fail(f"persistent frame launched closest_hit {n_k2}x, hitrec "
             f"{n_k1}x")
    if fb.shape != (H, W, 4) or not np.isfinite(fb).all() \
            or not fb[..., :3].max() > 0.0:
        fail(f"persistent frame: shape {fb.shape}, finite="
             f"{np.isfinite(fb).all()}")
    kernels["closest_hit"]["launches_persistent"] = n_k2
    kernels["hitrec"]["launches_persistent"] = n_k1
    print(f"persistent frame stress_highpoly {W}x{H} {SPP}spp "
          f"bounces={ren.max_depth} pool={ren.tile_rays}: "
          f"launches closest_hit {n_k2}, hitrec {n_k1}; pool steps "
          f"{calls['_pool_step']}, refills "
          f"{calls['_flush_pack_refill'] + calls['_flush_pack_refill_host']}"
          f", shrinks {calls['_pack_shrink']}; peak device memory "
          f"{peak / 2**30:.3f} GiB", flush=True)

    # ---- paths/s in turns: per-pass, persistent, persistent, per-pass
    rates = {"per-pass": [], "persistent": []}
    for _ in range(3):
        for kind in ("per-pass", "persistent", "persistent", "per-pass"):
            fn = frame_per_pass if kind == "per-pass" else frame_persistent
            rates[kind].append(W * H * SPP / fn(torch, ren))
    for kind, v in rates.items():
        print(f"paths/s {kind} frame (whole frame, {len(v)} frames in "
              f"turns): median {float(np.median(v)):.0f}, range "
              f"{min(v):.0f}-{max(v):.0f}; all "
              f"{' '.join(f'{x:.0f}' for x in v)}", flush=True)
    print_frame_profile(torch, lambda: ren.render_persistent(SPP,
                                                             fetch=False))
    return calls


# the scenes of tests/test_grad.py, tests/test_vertex_grad.py and
# tests/test_nee.py (copied: this script imports nothing of the tests,
# which import jax)
GRAD_SCENE = {
    "renderer": {"samples": 2, "bounces": 3, "width": 24, "height": 16},
    "camera": {"FOV": 70.0, "transforms": [
        {"type": "translate", "x": 0, "y": 0, "z": -4}]},
    "scene": {
        "ambientColor": {"down": {"r": 0.8, "g": 0.8, "b": 0.8},
                         "up": {"r": 0.4, "g": 0.6, "b": 0.9}},
        "primitives": [
            {"type": "sphere", "radius": 1.0,
             "color": {"r": 0.7, "g": 0.3, "b": 0.2}, "bsdf": "lambertian",
             "instances": [{"transforms": [
                 {"type": "translate", "x": 0, "y": 0, "z": 0}]}]},
            {"type": "sphere", "radius": 0.5,
             "color": {"r": 1.0, "g": 0.8, "b": 0.6}, "bsdf": "emissive",
             "intensity": 4.0,
             "instances": [{"transforms": [
                 {"type": "translate", "x": 1.5, "y": 1.0, "z": -0.5}]}]},
        ],
    },
}
FLAT_SCENE = {
    "renderer": {"samples": 1, "bounces": 2, "width": 96, "height": 64},
    "camera": {"FOV": 60.0, "transforms": [
        {"type": "translate", "x": 0, "y": 0.4, "z": -3.0}]},
    "scene": {
        "ambientColor": {"down": {"r": 1.0, "g": 0.9, "b": 0.8},
                         "up": {"r": 0.4, "g": 0.6, "b": 1.0}},
        "meshes": [{"fileName": "flatcube.obj", "bsdf": "lambertian",
                    "instances": [{"transforms": [
                        {"type": "rotateY", "degrees": 25}]}]}],
    },
}
NEE_SCENE = {
    "renderer": {"samples": 2, "bounces": 3, "width": 24, "height": 16},
    "camera": {"FOV": 70.0, "transforms": [
        {"type": "translate", "x": 0, "y": 0, "z": -4}]},
    "scene": {
        "ambientColor": {"down": {"r": 0.1, "g": 0.1, "b": 0.1},
                         "up": {"r": 0.1, "g": 0.1, "b": 0.1}},
        "primitives": [
            {"type": "sphere", "radius": 1.0,
             "color": {"r": 0.7, "g": 0.3, "b": 0.2}, "bsdf": "lambertian",
             "instances": [{"transforms": [
                 {"type": "translate", "x": 0, "y": 0, "z": 0}]}]},
            {"type": "sphere", "radius": 0.1,
             "color": {"r": 1.0, "g": 0.8, "b": 0.6}, "bsdf": "emissive",
             "intensity": 400.0,
             "instances": [{"transforms": [
                 {"type": "translate", "x": 2.5, "y": 2.0, "z": -1.5}]}]},
        ],
    },
}


def load_buf(scene: dict, device=None):
    """Compile a scene given as a dict (assets/ for its files)."""
    from craytpu_torch.scene.compile import compile_scene
    from craytpu_torch.scene.sceneloader import load_scene_from_buf
    return compile_scene(load_scene_from_buf(
        json.dumps(scene), os.path.join(REPO, "assets") + "/"), device)


def pixel_grid(torch, ren):
    """xs, ys of every pixel of ren's frame, row-major, on its device."""
    n = ren.width * ren.height
    i = torch.arange(n, dtype=torch.int32, device=ren.device)
    return i % ren.width, i // ren.width


def leaf_params(params):
    """A copy of ShadeParams whose tables require grad."""
    from dataclasses import fields, replace
    return replace(params, **{f.name: getattr(params, f.name).clone()
                              .requires_grad_() for f in fields(params)})


def table_grads(torch, params) -> dict:
    """Each table's gradient (zeros where none reached it)."""
    from dataclasses import fields
    return {f.name: (getattr(params, f.name).grad
                     if getattr(params, f.name).grad is not None
                     else torch.zeros_like(getattr(params, f.name)))
            for f in fields(params)}


def fwd_bwd(torch, trace, params, *args):
    """One fwd+bwd of loss = mean(img[..., :3]), synchronised through the
    loss value: (image, loss)."""
    img = trace(params, *args)
    loss = img[..., :3].mean()
    loss.backward()
    value = float(loss.detach())
    torch.cuda.synchronize()
    return img.detach(), value


def counted(torch, fn) -> tuple:
    """(fn(), K2 launches, K1 launches): both counters set to 0 just
    before fn and read just after."""
    from craytpu_torch.ops import hitrec as hr
    from craytpu_torch.ops import traverse as trv
    trv.closest_hit.launches = 0
    hr.hitrec_record.launches = 0
    out = fn()
    return out, trv.closest_hit.launches, hr.hitrec_record.launches


def kernel_ms(fn) -> dict:
    """Each kernel's launches and summed device ms over one fn() (CUDA
    events around each launch)."""
    from craytpu_torch.ops import cuda_build
    with cuda_build.launch_timing() as times:
        fn()
    return {name: (len(v), sum(ms for _, ms in v)) for name, v in
            times.items()}


def close(got, want, rtol, atol) -> tuple:
    """(every |got - want| <= atol + rtol |want|, max |d|, max of |d| over
    that tolerance) of two tensors; NaN is never close."""
    d = (got - want).abs()
    tol = atol + rtol * want.abs()
    return bool((d <= tol).all()), float(d.max()), float((d / tol).max())


def fd_check(torch, loss, params, name, idx, eps, ad, rel, abs_):
    """Central difference of loss in params.<name>[idx] against ad."""
    from dataclasses import replace
    vals = []
    for sgn in (1.0, -1.0):
        t = getattr(params, name).clone()
        t[idx] += sgn * eps
        with torch.no_grad():
            vals.append(float(loss(replace(params, **{name: t}))))
    fd = (vals[0] - vals[1]) / (2 * eps)
    return abs(fd - ad) <= max(rel * abs(fd), abs_), fd


def phase_grad(torch, kernels: dict, cs) -> None:
    """Phase 6: the differentiable trace on the card (cs: stress_highpoly
    compiled at 1080p)."""
    from craytpu_torch.models.wavefront_pt import WavefrontRenderer

    ren = WavefrontRenderer(cs)
    xs_all, ys_all, _, _ = ren._pixel_schedule
    B = min(1 << 20, xs_all.shape[0])
    xs, ys = xs_all[:B], ys_all[:B]
    t0 = time.perf_counter()
    sched = ren.census_schedule(xs, ys, spp=SPP, passes=[0], safety=1.05,
                                quant=1024, shrink_ratio=0.5)
    print(f"grad: census schedule (B={B}, pass 0 of {SPP}, "
          f"{ren.max_depth} bounces, {time.perf_counter() - t0:.2f} s): "
          f"{sched}", flush=True)
    trace = ren.make_trace_fn(remat="segment_hits", compaction=sched,
                              sort="boundary")
    args = (xs, ys, 0, SPP)
    state = {}

    def step():
        state["p"] = leaf_params(cs.params)
        state["img"], state["loss"] = fwd_bwd(torch, trace, state["p"],
                                              *args)
    step()                                                 # warm-up
    torch.cuda.reset_peak_memory_stats()
    secs = []
    for _ in range(2):
        t0 = time.perf_counter()
        step()
        secs.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    _, n_k2, n_k1 = counted(torch, step)
    with torch.no_grad():
        _, f_k2, f_k1 = counted(torch, lambda: trace(cs.params, *args))
    if n_k2 == 0 or n_k1 == 0:
        fail(f"fwd+bwd launched closest_hit {n_k2}x, hitrec {n_k1}x")
    if n_k2 != f_k2 or n_k1 != f_k1:
        fail(f"segment_hits fwd+bwd launched K2/K1 {n_k2}/{n_k1}x, the "
             f"forward alone {f_k2}/{f_k1}x")
    # (a) the forward image against trace_batch of the same lanes
    with torch.no_grad():
        want = ren.trace_batch(xs, ys, 0, SPP)
    ok, err, _ = close(state["img"], want, 2e-5, 2e-6)
    g = table_grads(torch, state["p"])
    finite = all(bool(torch.isfinite(v).all()) for v in g.values())
    print(f"grad (a): forward vs trace_batch max |d| {err:.3e} ok={ok}; "
          f"loss {state['loss']:.6f}; gradient max |g| per table: "
          + ", ".join(f"{k} {float(v.abs().max()):.3e}" for k, v in
                      g.items()) + f"; finite={finite}", flush=True)
    if not (ok and finite and float(g["colors"].abs().max()) > 0
            and float(g["emission"].abs().max()) > 0):
        fail("grad (a): forward image or gradients")
    ms = kernel_ms(step)
    for name, n in (("closest_hit", n_k2), ("hitrec", n_k1)):
        kernels[name]["launches_fwd_bwd"] = n
        kernels[name]["ms_fwd_bwd"] = ms.get(name, (0, 0.0))[1]
    rate = B / float(np.mean(secs))
    print(f"grad fwd+bwd stress_highpoly B={B} {ren.max_depth} bounces: "
          f"{' '.join(f'{x:.3f}' for x in secs)} s -> {rate:.0f} paths/s "
          f"(mean of 2); peak device memory {peak / 2**30:.3f} GiB; "
          f"launches per fwd+bwd closest_hit {n_k2}, hitrec {n_k1} (the "
          f"forward alone: {f_k2}, {f_k1}); device ms per fwd+bwd (CUDA "
          f"events) closest_hit {ms.get('closest_hit', (0, 0.0))[1]:.3f},"
          f" hitrec {ms.get('hitrec', (0, 0.0))[1]:.3f}", flush=True)
    print_frame_profile(torch, step)
    del state

    # full width with the vertex gradient (tri_packed, 130,560 rows)
    trace_g = ren.make_trace_fn(diff_geometry=True, remat="segment_hits",
                                compaction=sched, sort="boundary")

    def step_g():
        state["p"] = leaf_params(cs.params)
        state["tp"] = cs.geom.tri_packed.clone().requires_grad_()
        img = trace_g(state["p"], state["tp"], *args)
        loss = img[..., :3].mean()
        loss.backward()
        state["loss"] = float(loss.detach())
        torch.cuda.synchronize()
    state = {}
    step_g()                                               # warm-up
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, g_k2, g_k1 = counted(torch, step_g)
    sec_g = time.perf_counter() - t0
    peak_g = torch.cuda.max_memory_allocated()
    gt = state["tp"].grad
    nz = int((gt != 0).any(1).sum())
    print(f"grad fwd+bwd with diff_geometry=True: tri_packed "
          f"{tuple(gt.shape)}, {sec_g:.3f} s -> {B / sec_g:.0f} paths/s; "
          f"peak device memory {peak_g / 2**30:.3f} GiB; launches "
          f"closest_hit {g_k2}, hitrec {g_k1}; max |g| "
          f"{float(gt.abs().max()):.3e}, {nz} rows with a gradient, "
          f"finite={bool(torch.isfinite(gt).all())}", flush=True)
    if not (bool(torch.isfinite(gt).all()) and nz > 0) or g_k2 == 0:
        fail("grad: vertex gradient at full width")
    kernels["closest_hit"]["launches_fwd_bwd_geometry"] = g_k2
    kernels["hitrec"]["launches_fwd_bwd_geometry"] = g_k1
    del state

    # (b) 2^16 lanes: compacted + segment_hits + boundary sort against the
    # plain, uncompacted trace without remat
    b16 = min(1 << 16, B)
    a16 = (xs[:b16], ys[:b16], 0, SPP)
    s16 = ren.census_schedule(a16[0], a16[1], spp=SPP, passes=[0],
                              safety=1.05, quant=1024, shrink_ratio=0.5)
    res = {}
    for name, tr in (("plain", ren.make_trace_fn()),
                     ("compact", ren.make_trace_fn(
                         remat="segment_hits", compaction=s16,
                         sort="boundary"))):
        p = leaf_params(cs.params)
        (img, _), k2, _ = counted(torch, lambda: fwd_bwd(torch, tr, p,
                                                         *a16))
        with torch.no_grad():
            _, k2f, _ = counted(torch, lambda: tr(cs.params, *a16))
        res[name] = (img, table_grads(torch, p), k2, k2f)
    img_ok, img_err, _ = close(res["compact"][0], res["plain"][0], 2e-5,
                               2e-6)
    g_ok = True
    worst = 0.0
    for k, v in res["plain"][1].items():
        ok, _, ratio = close(res["compact"][1][k], v, 2e-4, 1e-6)
        g_ok &= ok
        worst = max(worst, ratio)
    k2c, k2cf = res["compact"][2], res["compact"][3]
    print(f"grad (b) B={b16} schedule {s16}: compacted vs plain image max "
          f"|d| {img_err:.3e} ok={img_ok}; gradients ok={g_ok} (worst "
          f"|d|/tol {worst:.3f}); K2 launches fwd+bwd {k2c}, forward alone "
          f"{k2cf} (plain trace: {res['plain'][2]}, {res['plain'][3]})",
          flush=True)
    if not (img_ok and g_ok and k2c == k2cf):
        fail("grad (b): compacted trace against the plain trace")

    # (c) finite differences on the card
    cs_g = load_buf(GRAD_SCENE)
    r_g = WavefrontRenderer(cs_g, bounces=3)
    tr_g = r_g.make_trace_fn(3)
    gx, gy = pixel_grid(torch, r_g)

    def loss_g(params):
        return tr_g(params, gx, gy, 0, 2)[..., :3].mean()
    p = leaf_params(cs_g.params)
    loss_g(p).backward()
    checked = []
    gc = p.colors.grad.cpu().numpy()
    for idx in np.argwhere(np.abs(gc) > 1e-4)[:8]:
        i, j = int(idx[0]), int(idx[1])
        ok, fd = fd_check(torch, loss_g, cs_g.params, "colors", (i, j),
                          2e-3, float(gc[i, j]), 2e-2, 1e-4)
        checked.append(("colors", i, j, float(gc[i, j]), fd, ok))
    ge = p.emission.grad.cpu().numpy()
    i, j = (int(v) for v in np.unravel_index(np.abs(ge).argmax(),
                                             ge.shape))
    ok, fd = fd_check(torch, loss_g, cs_g.params, "emission", (i, j), 1e-2,
                      float(ge[i, j]), 2e-2, 1e-4)
    checked.append(("emission", i, j, float(ge[i, j]), fd, ok))
    print("grad (c) FD, colors and emission (rel 2e-2, abs 1e-4): "
          + "; ".join(f"{n}[{a},{b}] AD {ad:.5f} FD {f:.5f}"
                      for n, a, b, ad, f, _ in checked), flush=True)
    if len(checked) < 3 or not all(c[-1] for c in checked):
        fail("grad (c): material gradients against finite differences")

    cs_f = load_buf(FLAT_SCENE)
    r_f = WavefrontRenderer(cs_f, bounces=2)
    tr_f = r_f.make_trace_fn(2, diff_geometry=True)
    yy, xx = np.mgrid[20:44, 30:60]
    fx = torch.tensor(xx.reshape(-1), dtype=torch.int32, device=cs_f.device)
    fy = torch.tensor(yy.reshape(-1), dtype=torch.int32, device=cs_f.device)

    def loss_f(tp):
        return tr_f(cs_f.params, tp, fx, fy, 0, 1)[..., :3].mean()
    tp0 = cs_f.geom.tri_packed
    tp = tp0.clone().requires_grad_()
    loss_f(tp).backward()
    gv = tp.grad.cpu().numpy().astype(np.float64)
    n_ok = n_bad = 0
    for f in np.argsort(-np.abs(gv).reshape(-1))[:40]:
        i, j = np.unravel_index(f, gv.shape)
        vals = []
        for sgn in (1.0, -1.0):
            t = tp0.clone()
            t[i, j] += sgn * 1e-3
            with torch.no_grad():
                vals.append(float(loss_f(t)))
        fd = (vals[0] - vals[1]) / 2e-3
        ad = gv[i, j]
        # entries whose FD straddles a visibility edge are skipped (the
        # detached search makes AD the interior derivative)
        if abs(fd - ad) > 0.05 * max(abs(fd), abs(ad)) and \
                abs(fd - ad) > 1e-4:
            continue
        if abs(fd - ad) <= max(5e-2 * abs(fd), 1e-4):
            n_ok += 1
        else:
            n_bad += 1
    print(f"grad (c) FD, flat cube vertices (rel 5e-2, abs 1e-4): "
          f"{n_ok} entries agree, {n_bad} disagree, of the 40 largest",
          flush=True)
    if n_ok < 25 or n_bad:
        fail("grad (c): vertex gradients against finite differences")


def phase_nee(torch, kernels: dict, cs) -> None:
    """Phase 7: next-event estimation on the card (cs: stress_highpoly
    compiled at 1080p)."""
    from dataclasses import replace

    from craytpu_torch.io.png import read_png_rgb
    from craytpu_torch.models.wavefront_pt import WavefrontRenderer
    from craytpu_torch.parallel.pool_shard import make_renderer

    # the three paths agree on tests/test_nee.py's scene
    cs_n = load_buf(NEE_SCENE)
    spp = 4
    r = WavefrontRenderer(cs_n, nee=True)
    xs, ys = pixel_grid(torch, r)
    trace = r.make_trace_fn(r.max_depth, nee=True)
    with torch.no_grad():
        want = sum(trace(cs_n.params, xs, ys, p, spp) for p in range(spp))
    want = (want / spp).reshape(r.height, r.width, 4)
    pool = torch.from_numpy(r.render_persistent(spp)).to(want.device)
    per_pass = torch.from_numpy(r.render(spp)).to(want.device)
    ok_pool, e_pool, _ = close(pool, want, 2e-5, 2e-6)
    ok_pass, e_pass, _ = close(per_pass, want, 2e-5, 2e-6)
    plain = WavefrontRenderer(cs_n).render(spp)
    print(f"nee: persistent vs trace max |d| {e_pool:.3e} ok={ok_pool}; "
          f"per-pass vs trace {e_pass:.3e} ok={ok_pass}; mean radiance NEE "
          f"{float(want[..., :3].mean()):.5f}, without "
          f"{float(plain[..., :3].mean()):.5f}", flush=True)
    if not (ok_pool and ok_pass):
        fail("nee: the three paths disagree")

    trace3 = r.make_trace_fn(depth=3, nee=True)

    def loss(params):
        return trace3(params, xs, ys, 0, 1)[..., :3].mean()
    em = cs_n.params.emission.clone().requires_grad_()
    loss(replace(cs_n.params, emission=em)).backward()
    k = int(torch.argmax(cs_n.params.emission[:, 0]))
    ad = float(em.grad[k, 0])
    ok, fd = fd_check(torch, loss, cs_n.params, "emission", (k, 0), 1e-2,
                      ad, 2e-3, 1e-6)
    print(f"nee: gradient of emission[{k},0] AD {ad:.6e} FD {fd:.6e} "
          f"(rtol 2e-3) ok={ok}", flush=True)
    if not ok or fd == 0.0:
        fail("nee: gradient against finite differences")

    # the persistent 1080p frame with NEE
    ren_n = make_renderer(cs, nee=True)
    ren_p = make_renderer(cs)
    frame_persistent(torch, ren_n)                         # warm-up
    torch.cuda.reset_peak_memory_stats()
    (fb, n_k2, n_k1) = counted(torch, lambda: ren_n.render_persistent(SPP))
    peak = torch.cuda.max_memory_allocated()
    if n_k2 == 0 or n_k1 == 0:
        fail(f"NEE frame launched closest_hit {n_k2}x, hitrec {n_k1}x")
    if fb.shape != (H, W, 4) or not np.isfinite(fb).all() \
            or not fb[..., :3].max() > 0.0:
        fail(f"NEE frame: shape {fb.shape}, finite={np.isfinite(fb).all()}")
    kernels["closest_hit"]["launches_nee"] = n_k2
    kernels["hitrec"]["launches_nee"] = n_k1
    rates = {"without NEE": [], "NEE": []}
    for _ in range(2):
        for kind in ("without NEE", "NEE", "NEE", "without NEE"):
            rn = ren_n if kind == "NEE" else ren_p
            rates[kind].append(W * H * SPP / frame_persistent(torch, rn))
    print(f"nee frame stress_highpoly {W}x{H} {SPP}spp persistent: "
          f"launches closest_hit {n_k2}, hitrec {n_k1}; peak device memory "
          f"{peak / 2**30:.3f} GiB; mean radiance "
          f"{float(fb[..., :3].mean()):.5f}", flush=True)
    for kind, v in rates.items():
        print(f"paths/s persistent frame {kind} ({len(v)} frames in "
              f"turns): median {float(np.median(v)):.0f}, range "
              f"{min(v):.0f}-{max(v):.0f}", flush=True)

    # the CLI with --nee
    cli_dir = os.path.join(REPO, "build", "chip_smoke", "cli_nee")
    os.makedirs(cli_dir, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "craytpu_torch",
           os.path.join(REPO, "assets", "stress_highpoly.json"), "-s",
           str(SPP), "-d", f"{W}x{H}", "--nee"]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=cli_dir, env=env, capture_output=True,
                         text=True, timeout=300)
    cli_s = time.perf_counter() - t0
    png = os.path.join(cli_dir, "output", "stress_highpoly_0000.png")
    if res.returncode != 0 or not os.path.exists(png):
        fail(f"CLI --nee exited {res.returncode}: {res.stderr[-2000:]}")
    img = read_png_rgb(png)
    if img.shape != (H, W, 3) or not img.max() > 0:
        fail(f"CLI --nee image: shape {img.shape}, max {img.max()}")
    print(f"CLI {' '.join(cmd[2:])}: exit 0 in {cli_s:.1f} s; wrote {png} "
          f"{img.shape}", flush=True)


# the scenes of tests/test_edge_grad.py, tests/test_edge_occluder.py and
# tests/test_edge_secondary.py: OBJ/MTL files and scene JSON (copied)
_QUAD = ("v -1.4 -1.1 0.8\nv 1.4 -1.1 0.8\nv 1.4 1.1 0.8\nv -1.4 1.1 0.8\n"
         "vt 0.5 0.5\nvn 0 0 -1\nusemtl bright\n"
         "f 1/1/1 2/1/1 3/1/1\nf 1/1/1 3/1/1 4/1/1\n")
_BRIGHT = "newmtl bright\nKd 0.85 0.85 0.85\nillum 2\n"
EDGE_FILES = {
    "tri": {"tri.obj": "mtllib tri.mtl\nv -0.8 -0.6 0.0\nv 0.8 -0.6 0.0\n"
                       "v 0.0 0.7 0.0\nvt 0.5 0.5\nvn 0 0 -1\nusemtl dark\n"
                       "f 1/1/1 2/1/1 3/1/1\n",
            "tri.mtl": "newmtl dark\nKd 0.12 0.12 0.12\nillum 2\n"},
    "occ": {"quad.obj": "mtllib quad.mtl\n" + _QUAD, "quad.mtl": _BRIGHT,
            "occ.obj": "mtllib occ.mtl\nv -0.55 -0.4 0.0\nv 0.55 -0.4 0.0\n"
                       "v 0.0 0.5 0.0\nvt 0.5 0.5\nvn 0 0 -1\nusemtl dark\n"
                       "f 1/1/1 2/1/1 3/1/1\n",
            "occ.mtl": "newmtl dark\nKd 0.08 0.08 0.08\nillum 2\n"},
    "sec": {"wall.obj": "mtllib wall.mtl\n" + _QUAD, "wall.mtl": _BRIGHT,
            "occ.obj": "mtllib occ.mtl\nv 1.4 -0.8 0.0\nv 2.4 -0.8 0.0\n"
                       "v 1.4 0.9 0.0\nvt 0.5 0.5\nvn 0 0 -1\nusemtl dark\n"
                       "f 1/1/1 2/1/1 3/1/1\n",
            "occ.mtl": "newmtl dark\nKd 0.05 0.05 0.05\nillum 2\n"},
}


def edge_scene(name: str, width: int, height: int) -> dict:
    """tri: one dark triangle against a bright constant ambient; occ: a
    dark occluder triangle over a bright receiver quad (two meshes); sec:
    a bright wall and a dark occluder outside the camera's frustum."""
    amb = 0.9 if name == "tri" else 0.65
    inst = [{"transforms": [{"type": "translate", "x": 0, "y": 0, "z": 0}]}]
    objs = [f for f in EDGE_FILES[name] if f.endswith(".obj")]
    return {
        "renderer": {"samples": 2, "bounces": 2, "width": width,
                     "height": height},
        "camera": {"FOV": 60.0, "transforms": [
            {"type": "translate", "x": 0, "y": 0, "z": -2.0}]},
        "scene": {
            "ambientColor": {"down": {"r": amb, "g": amb, "b": amb},
                             "up": {"r": amb, "g": amb, "b": amb}},
            "meshes": [{"fileName": f, "bsdf": "lambertian",
                        "instances": inst} for f in objs]}}


def edge_fd(torch, name: str, width: int, height: int, passes: int,
            samples: int, h: float, secondary: bool = False) -> dict:
    """AD of the frame's mean radiance (depth 2, `passes` passes) in the x
    of the last triangle's first vertex, with the boundary term
    (make_edge_grad_fn, or make_edge_grad2_fn if secondary) and without,
    and its central finite difference over fresh compile_scene calls of
    the scene with the vertex moved by +-h (as the JAX package's tests
    take it: the mesh BVHs stay those of the load)."""
    from craytpu_torch.models.wavefront_pt import WavefrontRenderer
    from craytpu_torch.ops import edge_grad as eg
    from craytpu_torch.ops import vecmath as vm
    from craytpu_torch.scene.compile import compile_scene
    from craytpu_torch.scene.sceneloader import load_scene_from_buf

    d = os.path.join(REPO, "build", "chip_smoke", f"edge_{name}")
    os.makedirs(d, exist_ok=True)
    for fname, text in EDGE_FILES[name].items():
        with open(os.path.join(d, fname), "w") as f:
            f.write(text)
    host = load_scene_from_buf(json.dumps(edge_scene(name, width, height)),
                               d + "/")
    cs = compile_scene(host)
    r = WavefrontRenderer(cs)
    xs, ys = pixel_grid(torch, r)
    trace = r.make_trace_fn(2, diff_geometry=True)
    make = eg.make_edge_grad2_fn if secondary else eg.make_edge_grad_fn
    boundary = make(cs, host, r, depth=2, samples_per_edge=samples)
    tp0 = cs.geom.tri_packed
    row = tp0.shape[0] - 1
    base = tp0[row]
    v1 = base[0:3] - base[3:6]
    v2 = base[6:9] + base[0:3]
    # the vertex's global index: the last mesh's first vertex
    vid = int(host.meshes[-1].tri_vidx[0, 0])

    def ad(with_boundary: bool) -> float:
        x = base[0].clone().requires_grad_()
        for p in range(passes):
            v0 = torch.stack([x, base[1], base[2]])
            e1, e2 = v0 - v1, v2 - v0
            # the JAX package's tests pack the normal with jnp.cross, and
            # the secondary test with the reference-rounded cross
            n = (vm.vcross(e1, e2) if secondary
                 else torch.linalg.cross(e1, e2, dim=-1))
            tp = torch.cat([tp0[:row], torch.cat([v0, e1, e2, n])[None]])
            img = trace(cs.params, tp, xs, ys, p, passes)
            if with_boundary:
                img = img + boundary(cs.params, tp, p, passes)
            (img[..., :3].mean() / passes).backward()
        return float(x.grad)

    def frame_loss(x: float) -> float:
        verts = host.vertices.copy()
        host.vertices[vid, 0] = x
        try:
            rr = WavefrontRenderer(compile_scene(host))
        finally:
            host.vertices = verts
        tr = rr.make_trace_fn(2)
        with torch.no_grad():
            return sum(float(tr(rr.cscene.params, xs, ys, p,
                                passes)[..., :3].mean())
                       for p in range(passes)) / passes

    x0 = float(base[0])
    if abs(float(host.vertices[vid, 0]) - x0) > 1e-6:
        fail(f"edge {name}: vertex {vid} is not the packed row's v0")
    t0 = time.perf_counter()
    out = {"ad": ad(True), "ad_interior": ad(False),
           "fd": (frame_loss(x0 + h) - frame_loss(x0 - h)) / (2 * h)}
    out["s"] = time.perf_counter() - t0
    return out


def phase_edge(torch, kernels: dict, cs, host) -> None:
    """Phase 8: edge-aware silhouette gradients and the inverse-rendering
    train step (cs: stress_highpoly compiled at 1080p; host: its loaded
    scene)."""
    from dataclasses import fields

    from craytpu_torch.models.wavefront_pt import WavefrontRenderer
    from craytpu_torch.ops import edge_grad as eg
    from craytpu_torch.ops import hitrec as hr
    from craytpu_torch.ops import traverse as trv
    from craytpu_torch.parallel import shard

    # FD gates of the JAX package's tests (tests/test_edge_grad.py,
    # tests/test_edge_occluder.py): AD with the boundary term within rtol
    # 0.3 of FD and of its sign; the interior estimator alone off by more
    # than 0.5 |FD|
    for name, w, hgt, passes, h in (("tri", 32, 24, 48, 0.04),
                                    ("occ", 64, 48, 32, 0.05)):
        res = edge_fd(torch, name, w, hgt, passes, 64, h)
        ad, fd, ai = res["ad"], res["fd"], res["ad_interior"]
        ok = (abs(fd - ai) > 0.5 * abs(fd) and np.sign(ad) == np.sign(fd)
              and abs(ad - fd) <= 0.3 * abs(fd))
        print(f"edge FD {name} {w}x{hgt} {passes} passes, 64 samples an "
              f"edge, h={h}: AD {ad:.6f}, AD interior only {ai:.6f}, FD "
              f"{fd:.6f}; AD/FD {ad / fd:.4f}; ok={ok} ({res['s']:.1f} s)",
              flush=True)
        if not ok:
            fail(f"edge FD {name}: the boundary gradient misses FD")
    # the secondary term on tests/test_edge_secondary.py's scene: reported
    res = edge_fd(torch, "sec", 32, 24, 24, 16, 0.1, secondary=True)
    ad, fd = res["ad"], res["fd"]
    print(f"edge FD sec (secondary term) 32x24 24 passes, 16 samples an "
          f"edge, h=0.1: AD {ad:.6f}, AD interior only "
          f"{res['ad_interior']:.6f}, FD {fd:.6f}; AD/FD "
          f"{ad / fd if fd else float('nan'):.4f} (reported, not a gate; "
          f"{res['s']:.1f} s)", flush=True)
    if not (np.isfinite(ad) and np.isfinite(fd)):
        fail("edge FD sec: AD or FD is not finite")

    # the train step at full width: the first 2^20 pixels of the 1080p
    # tile schedule, target 0.8 x a render of them
    ren = WavefrontRenderer(cs)
    xs_all, ys_all, _, _ = ren._pixel_schedule
    S = 32
    B = min(1 << 20, xs_all.shape[0])
    xs, ys = xs_all[:B], ys_all[:B]
    theta0 = (cs.params, cs.geom.tri_packed)
    k2, k1 = trv.closest_hit, hr.hitrec_record
    bwd = {"s": 0.0, "k2": 0, "k1": 0}
    orig_bwd = eg._Boundary.backward

    def timed_bwd(ctx, gbar):
        torch.cuda.synchronize()
        n2, n1, t0 = k2.launches, k1.launches, time.perf_counter()
        out = orig_bwd(ctx, gbar)
        torch.cuda.synchronize()
        bwd["s"] += time.perf_counter() - t0
        bwd["k2"] += k2.launches - n2
        bwd["k1"] += k1.launches - n1
        return out

    for geometry in (True, False):
        what = "geometry" if geometry else "material"
        with torch.no_grad():
            target = shard.make_sharded_render_fn(ren)(
                cs.params, xs, ys, 7)[..., :3] * 0.8
        step, init = shard.make_train_step(
            ren, learning_rate=5e-3, geometry=geometry, scene=host,
            edge_samples=S)
        theta = theta0 if geometry else cs.params
        state = init(theta)

        def run(th, st):
            th, st, loss = step(th, st, xs, ys, target, 0)
            return th, st, float(loss)
        theta, state, _ = run(theta, state)               # warm-up
        torch.cuda.reset_peak_memory_stats()
        secs = []
        for _ in range(2):
            t0 = time.perf_counter()
            theta, state, loss = run(theta, state)
            secs.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        # one more step, counted: K2/K1 launches (counts set to 0 just
        # before, read just after), the boundary's samples, and the
        # boundary backward timed alone (synchronised around it)
        eg.STATS.update(dict.fromkeys(eg.STATS, 0))
        eg._Boundary.backward = staticmethod(timed_bwd)
        try:
            t0 = time.perf_counter()
            (th2, _, loss2), n_k2, n_k1 = counted(
                torch, lambda: run(theta, state))
            sec_c = time.perf_counter() - t0
        finally:
            eg._Boundary.backward = orig_bwd
        if n_k2 == 0 or n_k1 == 0:
            fail(f"train step ({what}) launched closest_hit {n_k2}x, "
                 f"hitrec {n_k1}x")
        params2 = th2[0] if geometry else th2
        leaves = [getattr(params2, f.name) for f in fields(params2)]
        leaves += [th2[1]] if geometry else []
        finite = all(bool(torch.isfinite(x).all()) for x in leaves) \
            and np.isfinite(float(loss2))
        moved_tables = [f.name for f in fields(params2) if bool(
            (getattr(params2, f.name) != getattr(cs.params, f.name)).any())]
        line = (f"train step ({what}) stress_highpoly B={B} "
                f"{ren.max_depth} bounces, lr 5e-3: "
                f"{' '.join(f'{x:.3f}' for x in secs)} s -> "
                f"{float(np.mean(secs)):.3f} s a step (mean of 2), "
                f"{B / float(np.mean(secs)):.0f} paths/s; loss {loss:.6f}; "
                f"peak device memory {peak / 2**30:.3f} GiB; launches per "
                f"step closest_hit {n_k2}, hitrec {n_k1}; tables moved "
                f"{moved_tables}; finite={finite}")
        if geometry:
            rows = int((th2[1] != theta[1]).any(1).sum())
            st = eg.STATS
            line += (f"; tri_packed rows moved {rows} of "
                     f"{th2[1].shape[0]}; boundary backward "
                     f"{bwd['s']:.3f} s of the counted step's {sec_c:.3f} s "
                     f"({100 * bwd['s'] / sec_c:.1f}%), {st['backward']} "
                     f"call(s), launches closest_hit {bwd['k2']}, hitrec "
                     f"{bwd['k1']}; silhouette samples {st['silhouette']} of"
                     f" E x S = {st['samples'] // S} x {S} = "
                     f"{st['samples']} "
                     f"({100 * st['silhouette'] / max(st['samples'], 1):.2f}"
                     f"%), "
                     f"side rays traced {st['side_rays']}")
            if rows == 0 or st["backward"] == 0 or bwd["k2"] == 0:
                fail("train step (geometry): no row moved or the boundary "
                     "traced no side ray")
            for name, n in (("closest_hit", n_k2), ("hitrec", n_k1)):
                kernels[name]["launches_train_step"] = n
            kernels["closest_hit"]["launches_edge_backward"] = bwd["k2"]
            kernels["hitrec"]["launches_edge_backward"] = bwd["k1"]
        print(line, flush=True)
        if not finite or not moved_tables:
            fail(f"train step ({what}): non-finite values or no table moved")
        if geometry:
            print_frame_profile(torch, lambda: run(theta, state))
        del step, theta, state, th2, target
        torch.cuda.empty_cache()


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def cli_env() -> dict:
    return dict(os.environ, PYTHONPATH=REPO + os.pathsep
                + os.environ.get("PYTHONPATH", ""))


def start_worker_process(log_path: str):
    """`python3 -m craytpu_torch --worker <free port>` on this card, once
    it accepts connections: (process, port). Its output goes to log_path."""
    import socket
    port = free_port()
    log = open(log_path, "wb")
    proc = subprocess.Popen([sys.executable, "-m", "craytpu_torch",
                             "--worker", str(port)], cwd=REPO, env=cli_env(),
                            stdout=log, stderr=subprocess.STDOUT)
    log.close()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 120:
        if proc.poll() is not None:
            break
        try:
            # an empty session: the worker logs the hang-up and goes on
            socket.create_connection(("127.0.0.1", port), timeout=1).close()
            return proc, port
        except OSError:
            time.sleep(0.2)
    proc.kill()
    fail(f"worker did not listen (exit {proc.poll()}): {tail(log_path)}")


def tail(path: str, n: int = 3000) -> str:
    with open(path, "rb") as f:
        return f.read()[-n:].decode(errors="replace")


def cluster_session(name: str, overrides: dict, node: str):
    """Load a scene as the CLI's master does (its assets recorded) and
    ship it to the worker at `node`: (scene, scene renderer, clients)."""
    from craytpu_torch.parallel import cluster
    from craytpu_torch.parallel.pool_shard import make_renderer
    from craytpu_torch.scene.compile import compile_scene
    from craytpu_torch.scene.sceneloader import load_scene_from_buf
    from craytpu_torch.utils import fileio
    path = os.path.join(REPO, "assets", f"{name}.json")
    assets = fileio.start_recording()
    text = fileio.load_file(path, text=True)
    asset_path = os.path.dirname(path) + "/"
    scene = load_scene_from_buf(text, asset_path, overrides)
    fileio.stop_recording()
    clients = cluster.sync_with_clients(node, text, asset_path, assets,
                                        overrides)
    if len(clients) != 1:
        fail(f"cluster {name}: the worker at {node} did not load the scene")
    return scene, make_renderer(compile_scene(scene)), clients


class TileCount:
    """Counts the tiles this process renders through cluster.render_tile
    (the master's share), while installed."""

    def __init__(self):
        from craytpu_torch.parallel import cluster
        self.cluster, self.orig, self.n = cluster, cluster.render_tile, 0

        def counted(*a):
            self.n += 1
            return self.orig(*a)
        cluster.render_tile = counted

    def close(self):
        self.cluster.render_tile = self.orig


def clustered_frame(torch, scene, r, clients, spp):
    """One render_clustered frame: (frame, wall s, master tiles, the
    worker's last (completed, avg ms) stats push or None)."""
    from craytpu_torch.parallel import cluster
    stats = {}
    count = TileCount()
    try:
        t0 = time.perf_counter()
        fb = cluster.render_clustered(
            scene, r, clients, spp,
            on_stats=lambda n, c, avg: stats.update(last=(c, avg)))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        count.close()
    return fb, secs, count.n, stats.get("last")


def phase_cluster(torch, kernels: dict) -> None:
    """Phase 9: the TCP cluster on one card (master plus a worker
    process, against the master alone)."""
    from craytpu_torch.ops import hitrec as hr
    from craytpu_torch.ops import traverse as trv
    from craytpu_torch.parallel import cluster
    from craytpu_torch.runtime.tile import quantize_image
    from craytpu_torch.utils import golden

    out_dir = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    log = os.path.join(out_dir, "worker.log")
    t0 = time.perf_counter()
    proc, port = start_worker_process(log)
    node = f"127.0.0.1:{port}"
    print(f"cluster: worker pid {proc.pid} listening on {node} after "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    try:
        # ---- the golden gate through the cluster path, master + worker
        for name in ("stress_highpoly", "stress_instances"):
            scene, r, clients = cluster_session(
                name, {"width": 80, "height": 50, "samples": 4}, node)
            fb, secs, mine, _ = clustered_frame(torch, scene, r, clients, 4)
            for _, sock in clients:
                sock.close()
            ok, within, mean_abs = golden.compare(fb, name, 80, 50, 4)
            n_tiles = len(quantize_image(80, 50, 64, 64))
            print(f"cluster golden {name} 80x50 4spp (master + worker, "
                  f"tiles {mine} master / {n_tiles - mine} worker): "
                  f"within1lsb={within:.5f} mean_abs={mean_abs:.4f} ok={ok}",
                  flush=True)
            if not ok:
                fail(f"cluster golden {name}")

        # ---- the 1080p frame: one session, a startRender a frame
        t1 = time.perf_counter()
        scene, r, clients = cluster_session(
            "stress_highpoly", {"width": W, "height": H, "samples": SPP},
            node)
        p = scene.prefs
        tw, th = min(p.tile_width, W), min(p.tile_height, H)
        tiles = quantize_image(W, H, tw, th, p.tile_order)
        print(f"cluster: 1080p scene shipped and loaded by the worker in "
              f"{time.perf_counter() - t1:.1f} s; {len(tiles)} tiles of "
              f"{tw}x{th}, {r.max_depth} bounces", flush=True)
        t_dict = {"begin_x": tiles[0].begin_x, "begin_y": tiles[0].begin_y,
                  "end_x": tiles[0].end_x, "end_y": tiles[0].end_y}
        cluster.render_tile(r, t_dict, 1, tw, th)               # warm-up
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(3):
            cluster.render_tile(r, t_dict, 1, tw, th)
        torch.cuda.synchronize()
        tile_s = (time.perf_counter() - t1) / 3
        # the largest spp of {4, 2, 1} whose frames (about 3.2 master-alone
        # frames' time for the turns below) stay under 100 s
        est = {s: tile_s * len(tiles) * s for s in (4, 2, 1)}
        spp = next((s for s in (4, 2, 1) if 3.2 * est[s] <= 100.0), 1)
        turns = (["alone", "worker", "worker", "alone"]
                 if 3.2 * est[spp] <= 100.0 else ["alone", "worker"])
        print(f"cluster: one {tw}x{th} tile pass {tile_s * 1e3:.2f} ms -> a "
              f"master-alone frame about {est[spp]:.1f} s at {spp} spp; "
              f"running {spp} spp (of the scene's {SPP}), turns {turns}",
              flush=True)

        torch.cuda.synchronize()
        acc = torch.zeros((H, W, 4), device="cuda")
        for p_i in range(spp):
            acc = r.render_pass(acc, p_i, spp)
        want = acc.cpu().numpy()
        rates = {"alone": [], "worker": []}
        for kind in turns:
            cl = [] if kind == "alone" else clients
            counting = kind == "alone" and not rates["alone"]
            if counting:
                trv.closest_hit.launches = 0
                hr.hitrec_record.launches = 0
            fb, secs, mine, st = clustered_frame(torch, scene, r, cl, spp)
            if counting:
                n_k2 = trv.closest_hit.launches
                n_k1 = hr.hitrec_record.launches
                kernels["closest_hit"]["launches_cluster"] = n_k2
                kernels["hitrec"]["launches_cluster"] = n_k1
            err = float(np.max(np.abs(fb - want)))
            if not np.allclose(fb, want, rtol=2e-6, atol=2e-7):
                fail(f"clustered frame ({kind}) differs from render_pass: "
                     f"max |d| {err}")
            rates[kind].append(W * H * spp / secs)
            line = (f"cluster frame ({kind}) {W}x{H} {spp}spp: {secs:.2f} s, "
                    f"{W * H * spp / secs:.0f} paths/s; tiles {mine} master"
                    f" / {len(tiles) - mine} worker")
            if st is not None:
                line += (f"; worker stats push: {st[0]} tiles, "
                         f"{st[1]:.2f} ms a tile")
            if counting:
                line += f"; launches closest_hit {n_k2}, hitrec {n_k1}"
            print(line + f"; max |d| to render_pass {err:.3e}", flush=True)
            if kind == "alone" and mine != len(tiles) or \
                    kind == "worker" and mine == len(tiles):
                fail(f"cluster frame ({kind}): the master rendered {mine} "
                     f"of {len(tiles)} tiles")
        for _, sock in clients:
            sock.close()
        frame_persistent(torch, r)                            # warm-up
        pers = [W * H * SPP / frame_persistent(torch, r) for _ in range(2)]
        alone, both = (" ".join(f"{x:.0f}" for x in rates[k])
                       for k in ("alone", "worker"))
        print(f"cluster paths/s: master alone {alone}; master + worker "
              f"{both}; ratio of medians "
              f"{np.median(rates['worker']) / np.median(rates['alone']):.3f}; "
              f"persistent frame ({SPP}spp, for scale) "
              f"{' '.join(f'{x:.0f}' for x in pers)}", flush=True)

        # ---- --shutdown --nodes ends the worker with exit 0
        t1 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "craytpu_torch",
                              "--shutdown", "--nodes", node], cwd=REPO,
                             env=cli_env(), capture_output=True, text=True,
                             timeout=120)
        if res.returncode != 0:
            fail(f"--shutdown exited {res.returncode}: {res.stderr[-2000:]}")
        try:
            rc = proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            fail("the worker did not exit within 30 s of --shutdown")
        if rc != 0:
            fail(f"the worker exited {rc}: {tail(log)}")
        print(f"cluster: --shutdown --nodes {node}: worker exited 0 "
              f"{time.perf_counter() - t1:.1f} s after the command started",
              flush=True)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def turns_rates(torch, frames: dict, rounds: int = 2) -> dict:
    """paths/s of each frame function in turns (a, b, b, a), `rounds`
    times: {name: [paths/s, ...]}."""
    a, b = frames
    rates = {a: [], b: []}
    for _ in range(rounds):
        for kind in (a, b, b, a):
            rates[kind].append(W * H * SPP / frames[kind]())
    return rates


def fmt_rates(rates: dict) -> str:
    return "; ".join(f"{k}: median {float(np.median(v)):.0f} (all "
                     f"{' '.join(f'{x:.0f}' for x in v)})"
                     for k, v in rates.items())


# tests/test_debug.py's scene (copied: this script imports nothing of the
# tests, which import jax)
DEBUG_SCENE = {
    "renderer": {"samples": 1, "bounces": 4, "width": 16, "height": 12},
    "camera": {"FOV": 70.0, "transforms": [
        {"type": "translate", "x": 0, "y": 0, "z": -4}]},
    "scene": {
        "ambientColor": {"down": {"r": 0.2, "g": 0.2, "b": 0.2},
                         "up": {"r": 0.6, "g": 0.6, "b": 0.8}},
        "primitives": [
            {"type": "sphere", "radius": 1.2,
             "color": {"r": 0.7, "g": 0.3, "b": 0.2},
             "bsdf": "lambertian",
             "instances": [{"transforms": [
                 {"type": "translate", "x": 0, "y": 0, "z": 0}]}]},
        ],
    },
}


def phase_tools(torch, pool_calls: dict) -> None:
    """Phase 10: the live preview, --trace, debug mode, pool statistics
    and test dispatch, at 1080p on stress_highpoly (pool_calls: phase
    5's pool steps, refills and shrinks of the same frame)."""
    import threading
    import urllib.request
    from dataclasses import replace

    from craytpu_torch.io.png import decode_png_rgb
    from craytpu_torch.models.wavefront_pt import WavefrontRenderer
    from craytpu_torch.ops.hitrec import Isect
    from craytpu_torch.parallel.pool_shard import make_renderer
    from craytpu_torch.runtime.preview import PreviewServer, frame_hook
    from craytpu_torch.scene.compile import compile_scene

    cs = compile_scene(load("stress_highpoly", {"width": W, "height": H,
                                                "samples": SPP}))
    ren = make_renderer(cs)
    plain = ren.render_persistent(SPP)                        # warm-up

    # ---- preview: a PreviewServer fed through on_frame, in turns with the
    # frame without it; status.json and frame.png fetched during the render
    # (every 0.1 s until the first frame.png, then once a second, as the
    # page does)
    srv = PreviewServer(W, H, port=0)
    base = srv.start()
    got = {"status": 0, "png": None, "png_done": 0}

    def previewed():
        done = threading.Event()

        def poll():
            while not done.is_set():
                with urllib.request.urlopen(base + "status.json",
                                            timeout=30) as resp:
                    s = json.loads(resp.read())
                got["status"] += 1
                if s["version"] >= 1 and got["png"] is None:
                    with urllib.request.urlopen(base + "frame.png",
                                                timeout=30) as resp:
                        got["png"], got["png_done"] = resp.read(), s["done"]
                done.wait(0.1 if got["png"] is None else 1.0)
        t = threading.Thread(target=poll, daemon=True)
        t.start()
        try:
            t0 = time.perf_counter()
            ren.render_persistent(SPP, fetch=False,
                                  on_frame=frame_hook(srv, ren, SPP))
            torch.cuda.synchronize()
            return time.perf_counter() - t0
        finally:
            done.set()
            t.join(timeout=60)

    try:
        rates = turns_rates(torch, {"without": lambda: frame_persistent(
            torch, ren), "preview": previewed})
    finally:
        srv.stop()
    if got["png"] is None:
        fail("preview: no frame.png was served during the renders")
    img = decode_png_rgb(got["png"])
    if img.shape != (H, W, 3) or not img.max() > 0:
        fail(f"preview frame.png: shape {img.shape}, max {img.max()}")
    print(f"preview {W}x{H} {SPP}spp persistent frame, paths/s in turns: "
          f"{fmt_rates(rates)}; preview/without medians "
          f"{np.median(rates['preview']) / np.median(rates['without']):.3f}; "
          f"{got['status']} status.json fetches; frame.png "
          f"{len(got['png'])} B at {got['png_done']} paths done decodes to "
          f"{img.shape}", flush=True)

    # ---- --trace: the CLI under torch.profiler
    tdir = os.path.join(REPO, "build", "chip_smoke", "trace")
    os.makedirs(tdir, exist_ok=True)
    cmd = [sys.executable, "-m", "craytpu_torch",
           os.path.join(REPO, "assets", "stress_highpoly.json"), "-s",
           str(SPP), "-d", f"{W}x{H}", "--trace", "trc"]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=tdir, env=cli_env(), capture_output=True,
                         text=True, timeout=300)
    cli_s = time.perf_counter() - t0
    path = os.path.join(tdir, "trc", "stress_highpoly_trace.json")
    if res.returncode != 0 or not os.path.exists(path):
        fail(f"--trace CLI exited {res.returncode}: {res.stderr[-2000:]}")
    with open(path, "rb") as f:
        blob = f.read()
    names = {k: blob.count(v.encode()) for k, v in KERNEL_NAMES.items()}
    if not all(names.values()):
        fail(f"--trace: the trace does not name both kernels: {names}")
    done = [ln for ln in res.stdout.splitlines() if "Finished" in ln]
    print(f"trace: CLI {' '.join(cmd[3:])}: exit 0 in {cli_s:.1f} s "
          f"(process start, scene load, profiler start and export "
          f"included); {done[-1] if done else ''}; trace "
          f"{len(blob) / 1e6:.1f} MB, kernel events "
          f"{names}", flush=True)
    del blob

    # ---- debug mode: the clean frame unchanged, its cost; a NaN albedo
    # and an out-of-range id raise. The per-pass frame is held bit for bit.
    # The persistent frame is held at the resume tolerance: its flushes
    # add the radiance of two passes of one pixel in one index_add_, whose
    # atomics add in no fixed order, so a few values differ in their last
    # bits from run to run (scripts/torch_repro.py).
    os.environ["CRAYTPU_DEBUG"] = "1"
    try:
        dbg = make_renderer(cs)
        if not dbg._debug:
            fail("CRAYTPU_DEBUG=1 did not turn debug mode on")
        secs = {}
        frames = {}
        for name, r_, fn in (("per-pass", ren, "render"),
                             ("per-pass debug", dbg, "render"),
                             ("persistent debug", dbg, "render_persistent"),
                             ("persistent", ren, "render_persistent")):
            t0 = time.perf_counter()
            frames[name] = getattr(r_, fn)(SPP)
            secs[name] = time.perf_counter() - t0
        bits = {k: int((frames[k].view(np.uint32)
                        != frames[f"{k} debug"].view(np.uint32)).sum())
                for k in ("per-pass", "persistent")}
        if bits["per-pass"] or not np.allclose(
                frames["persistent debug"], plain, rtol=2e-5, atol=2e-6):
            fail(f"debug mode changed the clean frame: {bits} values differ")
        small = load_buf(DEBUG_SCENE)
        colors = small.params.colors.clone()
        colors[:, 0] = float("nan")
        small.params = replace(small.params, colors=colors)
        try:
            WavefrontRenderer(small).render(1)
            fail("debug mode: a NaN albedo did not raise")
        except FloatingPointError as e:
            nan_msg = str(e)
        isect = Isect(small)
        o = torch.zeros((4, 3), device="cuda")
        d = torch.tensor([[0.0, 0.0, 1.0]] * 4, device="cuda")
        t_k, prim, inst, rec = isect.search(
            small.geom, o, d, torch.ones(4, dtype=torch.bool, device="cuda"))
        try:
            isect.resolve((t_k, prim, inst + 7, rec), o, d)
            fail("debug mode: an out-of-range id did not raise")
        except IndexError as e:
            id_msg = str(e)
    finally:
        del os.environ["CRAYTPU_DEBUG"]
    print(f"debug: CRAYTPU_DEBUG=1 frame s (without / with): per-pass "
          f"{secs['per-pass']:.2f} / {secs['per-pass debug']:.2f}, "
          f"persistent {secs['persistent']:.2f} / "
          f"{secs['persistent debug']:.2f}; values that differ from the "
          f"frame without debug: per-pass {bits['per-pass']}, persistent "
          f"{bits['persistent']} (of {frames['persistent'].size}); NaN "
          f"albedo raised: {nan_msg}; bad id raised: {id_msg}", flush=True)

    # ---- pool statistics: the counts equal phase 5's; per-phase walls
    os.environ["CRAYTPU_POOL_STATS"] = "1"
    try:
        ren.render_persistent(SPP, fetch=False)
        st = ren.pool_stats
        want = (pool_calls["_pool_step"], pool_calls["_flush_pack_refill"]
                + pool_calls["_flush_pack_refill_host"],
                pool_calls["_pack_shrink"])
        if (st["steps"], st["refills"], st["shrinks"]) != want:
            fail(f"pool stats {st['steps']}/{st['refills']}/{st['shrinks']} "
                 f"differ from phase 5's counts {want}")
        os.environ["CRAYTPU_POOL_SYNC"] = "1"
        t0 = time.perf_counter()
        ren.render_persistent(SPP, fetch=False)
        sync_s = time.perf_counter() - t0
        ws = ren.pool_stats["phase_wall_s"]
    finally:
        os.environ.pop("CRAYTPU_POOL_STATS", None)
        os.environ.pop("CRAYTPU_POOL_SYNC", None)
    print(f"pool stats (CRAYTPU_POOL_STATS=1): {st['steps']} steps, "
          f"{st['refills']} refills, {st['shrinks']} shrinks (= phase 5), "
          f"occupancy {st['occupancy']:.3f}, "
          f"{st['bounces_per_path']:.3f} lane-bounces a path; "
          f"CRAYTPU_POOL_SYNC=1 frame {sync_s:.2f} s: step "
          f"{ws['step']:.3f} s, refill {ws['refill']:.3f} s, shrink "
          f"{ws['shrink']:.3f} s", flush=True)

    # ---- test dispatch: --test-perf and --tcount
    for flags, check in ((["--test-perf"], lambda out: len(
            [ln for ln in out.splitlines() if "[perf]" in ln]) == 5),
            (["--tcount"], lambda out: out.strip().splitlines()[-1].isdigit()
             and int(out.strip().splitlines()[-1]) > 0)):
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "craytpu_torch"] + flags,
                             cwd=REPO, env=cli_env(), capture_output=True,
                             text=True, timeout=300)
        if res.returncode != 0 or not res.stdout.strip() \
                or not check(res.stdout):
            fail(f"{flags[0]} exited {res.returncode}: {res.stdout[-2000:]}"
                 f" {res.stderr[-2000:]}")
        lines = [ln.split("] ", 2)[-1] for ln in res.stdout.splitlines()
                 if "[perf]" in ln or "leaving out" in ln] + (
            [] if flags[0] == "--test-perf"
            else [f"count {res.stdout.strip().splitlines()[-1]}"])
        print(f"{flags[0]}: exit 0 in {time.perf_counter() - t0:.1f} s: "
              f"{' | '.join(lines)}", flush=True)


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs one card")
    try:
        from craytpu_torch.ops import cuda_build
        from craytpu_torch.utils.torchsetup import setup_torch
    except ImportError as e:
        fail(f"the craytpu_torch package is not here: {e}")
    print(card_line(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    setup_torch()
    secs = cuda_build.build_all()
    print(f"build: {secs:.1f} s -> {cuda_build.BUILD_DIR}", flush=True)
    for line in cuda_build.usage_lines():
        print(f"  {line}", flush=True)
    kernels = phase_kernels(torch)
    phase_golden(torch)
    phase_render(torch, kernels)
    pool_calls = phase_persistent(torch, kernels)
    from craytpu_torch.scene.compile import compile_scene
    host = load("stress_highpoly", {"width": W, "height": H, "samples": SPP})
    cs = compile_scene(host)
    phase_grad(torch, kernels, cs)
    phase_nee(torch, kernels, cs)
    phase_edge(torch, kernels, cs, host)
    del cs, host
    torch.cuda.empty_cache()
    phase_cluster(torch, kernels)
    phase_tools(torch, pool_calls)
    print(json.dumps({"kernels": [kernels["closest_hit"],
                                  kernels["hitrec"]]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
