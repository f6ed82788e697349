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


def phase_persistent(torch, kernels: dict) -> None:
    """Phase 5: the CLI's path, the persistent pool, on the card."""
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
    phase_persistent(torch, kernels)
    print(json.dumps({"kernels": [kernels["closest_hit"],
                                  kernels["hitrec"]]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
