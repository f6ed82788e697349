"""Smoke run of the PyTorch/CUDA port (craytpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. build   — nvcc builds the three kernels from craytpu_torch/csrc, each
               in its exact and its fast variant (six nvcc processes in
               parallel), into build/craytpu_torch/, and prints each
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
               K3 (dense closest hit): K2's 2^16 rays, against its plain
               version on the card (on the CPU it would take minutes),
               with its cull's counters from the plain cull model
               (dense_cull_counts) and two bounds: the culled search's
               (the row's) and the full search's; then every lane of two
               grazing batches (graze_batch: rays at 0 to 2^-5 rad off
               a triangle's plane, through it and beside it, near and
               far, on stress_highpoly and on a tilted floor whose
               in-plane rays only rounding hits). Each bound is the
               larger of the bytes over the HBM rate and the f32
               operations over the f32 lane rate (-fmad=false); K2's also
               from its visits (each node record and triangle it reads,
               counted a read).
  3. golden  — stress_highpoly and stress_instances at 80x50, 4 spp,
               through the kernels and CUDA graphs (the default path),
               against goldens/*_80_4.png at the thresholds of
               craytpu_torch/utils/golden.py.
  4. render  — the main path at full width: Renderer.load_scene_from_file
               -> start_renderer -> write_image on
               assets/stress_highpoly.json at 1920x1080, its own 12
               bounces, 4 spp, after one warm-up pass. Launch counters
               are set to 0 just before and read just after; both kernels
               must have launched (the counts include the launches of
               CUDA graph replays). Prints paths/s and peak device
               memory. Then graph_vs_eager on per-pass 1080p frames
               (WavefrontRenderer with and without CUDA graphs, one
               compiled scene): the graph renderer's captures and the
               seconds of each key's first call; a counted frame of each
               (replays and captures a frame, launches and the replays'
               share of them, host ms a dispatch, peak memory); the
               graph frame bit-equal to the eager frame and to itself;
               paths/s in turns (graphs, eager, eager, graphs, twice);
               a profiled frame of each (device busy share; the graph
               frame's kernel breakdown, each kernel's launches and
               device time from the profiler, which sees replays).
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
               device memory; check_flush (the framebuffer flush:
               deterministic over three runs, its order of adds); and
               graph_vs_eager (phase 4) on persistent 1080p frames.
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
               turns with the frame without NEE (one round);
               graph_vs_eager (phase 4) on NEE frames; and `python3 -m
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
               stress_highpoly at 1920x1080, its 64x64 tiles and 6
               bounces (cut from its 12; CLUSTER_BOUNCES), one session:
               one tile pass is timed first and the
               largest spp of {4, 2, 1} whose frames fit about 30 s is
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
               names closest_hit_kernel and hitrec_kernel, and its
               frames.json holds a profiled frame record; its size and the
               CLI's wall time); CRAYTPU_DEBUG=1 (eager): the clean
               per-pass and persistent frames bit-equal to the frames
               without it, their times, a NaN albedo and an out-of-range id raise;
               CRAYTPU_TRACE=1: the frame record's step, refill and
               shrink counts equal phase 5's, no capture, each dispatch
               kind's device ms and the longest idle gaps with the span
               the host was in; `--test-perf` prints its five lines and
               `--tcount` a positive count.
  11. shard  — the renderer and the train step over a process group
               (craytpu_torch/parallel/dist.py, pool_shard.py, shard.py)
               on this one card. A 1-rank NCCL group in this process:
               ShardedPoolRenderer's 1080p persistent frame against the
               single-card frame (rtol=2e-5, atol=2e-6), and a 64x64 tile
               at 4 spp through render_ids against render_tile's eager
               path (same tolerance), each timed 3 times. A 2-rank gloo
               group sharing the card (dist.spawn_local): the 1080p frame
               with each rank's K2/K1 launches (counts set to 0 just
               before, read just after; every rank must launch both),
               equal on every rank and to the 1-rank frame; paths/s of 2
               ranks and of 1 rank (rank 0 alone) in turns; an interrupt
               at the 3rd poll on entry_scene (96x64, 3 spp, k=1) resumed
               on 1 rank against the uninterrupted frame; the material
               train step on a (1, 2) mesh against the one-card step on
               the first 2^20 pixels (loss rtol=1e-5, tables atol=1e-6
               where the gradient counts), timed in turns. Then both
               stress goldens at 80x50, 4 spp, through the 2-rank CLI
               (CRAYTPU_COORDINATOR and friends; exactly one PNG), and
               craytpu_torch.entry.dryrun_multichip(2).
  12. dense  — CRAYTPU_TRAVERSAL=dense, the dense search (K3) in place of
               the walk (K2). On the 1080p frame's first 2^20-lane
               primary batch K3's winners against K2's: hit/miss
               identical, (inst, prim) equal on >= 0.999 of the lanes, K1
               records bit-equal where they are; K3's time there; K3
               bit-equal to its plain version on every lane of that
               launch and on a 16,384-lane launch of its first lanes;
               the cull's counters and both bounds on every 16th block
               of 256 lanes, scaled by 16; every lane of a grazing batch
               of stress_highpoly. Both
               stress goldens at 80x50, 4 spp, per pass (render) and
               persistent (make_renderer), K3 launched and K2 not. A
               1-spp persistent 1080p frame picks the largest spp of {4,
               2, 1} whose three frames fit DENSE_FRAMES_S; at that spp
               `CRAYTPU_TRAVERSAL=dense python3 -m craytpu_torch
               assets/stress_highpoly.json -d 1920x1080` (exit 0, a
               1920x1080 PNG), and persistent frames in turns (dense,
               walk, walk, dense), paths/s, the first dense frame's
               launches (counts set to 0 just before, read just after; K3
               must launch and K2 must not), both frames' peak device
               memory, and graph_vs_eager (phase 4, one round of turns)
               on dense frames. Last,
               a diff_geometry fwd+bwd on tests/test_vertex_grad.py's
               cube under dense against the walk's: image and gradients
               within rtol=2e-4, atol=1e-6.
  13. switches — CRAYTPU_FASTMATH and what K1 is worth, on persistent
               1080p frames of stress_highpoly in turns (A, B, B, A).
               CRAYTPU_FASTMATH (read at import): four child processes,
               exact, fast, fast, exact, each timing one frame after a
               warm-up; the first fast one also holds the fast variant
               of K1, K2 and K3 against its fast plain version on the
               card at phase 2's shapes and K3 on its grazing batches
               (bit-equal, or the phase fails), times them, and prints
               both stress goldens at 80x50, 4 spp (not gated: fast math
               is not golden-exact); each fast bound scales the exact
               operation count by the variants' f32 SASS instructions. Then K1's
               records against the plain version's (plain_records swaps
               the record function for those frames; the port's
               CRAYTPU_HITREC=xla maps to K1): paths/s and K1's launches
               (> 0, and 0 with the plain record; counters set to 0 just
               before, read just after); the frames agree within
               rtol=2e-5, atol=2e-6.
Then a summary line a path of graph_vs_eager, the script's seconds, one
line {"kernels": [...]} (launches count graph replays; launches_sharded:
each rank's launches in phase 11's 2-rank frame; K3's launches: phase
12's dense frame;
ms_fast and plain_ms_fast: the fast variants, phase 13) and, last, the ok
line with the device.
Needs one CUDA card; exits 1 without one.
"""

from __future__ import annotations

import contextlib
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
# lane (the whole record). Every kernel is built with -fmad=false, so each
# of these runs as one instruction at the f32 lane rate
# (F32_LANE_OPS_PER_S below), as K3's do.
K2_OPS_INNER, K2_OPS_TRI, K2_OPS_SPHERE = 24, 311, 619
K1_OPS_LANE = 1851
# K2's reads a visit (csrc/closest_hit.cu): an inner node's 64-byte record
# (KernelLayout.node_rec, both children's boxes), a tested triangle's
# 48-byte packed row (KernelLayout.tri_leaf)
K2_NODE_BYTES, K2_TRI_BYTES = 64, 48
# K1 bytes per lane: 7 ray floats and 2 ids in, 16 record floats out; the
# tri_wide (32-float) and inst_wide (28-float) rows count once per row read
K1_BYTES_LANE = (7 + 2 + 16) * 4
K1_BYTES_TRI_ROW, K1_BYTES_INST_ROW = 32 * 4, 28 * 4
# The dense search's f32 operations, counted from csrc/dense_hit.cu
# (compares and selects not counted), none fused, so they run at the
# card's f32 lane rate: half the 67 TFLOP/s peak, which counts an fma as
# two operations. A (ray, triangle) pair needs det (5), t*det (6), 1/det
# and t to be rejected on its t: K3_OPS_T. Only a pair whose t passes 0
# <= t <= the ray's final best needs u*det and v*det (11 each), u, v and
# u + v to be decided: K3_OPS_UV more. A box test (box_keep) costs
# K3_OPS_SLAB for its slab test, and K3_OPS_PLANE more for its plane test
# where the slab test skips the box (counted only for the boxes the lane
# skips: a box the lane keeps may have taken either). A sphere instance
# costs a K2 sphere test. The full search's bound counts every live pair
# (K3 before its cull); the culled bound counts the box tests a lane
# makes (its root box, every superblock box of an instance whose root it
# keeps, the group boxes of the superblocks it votes for) and the pairs
# of the groups it votes for.
K3_OPS_T, K3_OPS_UV, K3_OPS_SLAB, K3_OPS_PLANE = 13, 25, 31, 56
F32_LANE_OPS_PER_S = F32_OPS_PER_S / 2
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
    t_ops = ops / F32_LANE_OPS_PER_S * 1e3
    # the walk's own reads, counted a visit (what the kernel reads, not
    # each row once): 64 B a node record (K2_NODE_BYTES) an inner-node
    # visit and 48 B a packed triangle (K2_TRI_BYTES) a triangle test,
    # beside the rays' words, priced at the HBM rate; the same
    # operations. A traffic figure, not a roofline: the tables fit in the
    # L2, so most of these re-reads never reach HBM and the time it gives
    # is more than the kernel must take. bound_ms stays the bound.
    vbytes = (B2 * (7 + 3) * 4 + counts["inner"] * K2_NODE_BYTES
              + counts["tri"] * K2_TRI_BYTES)
    t_vbytes = vbytes / HBM_BYTES_PER_S * 1e3
    out["closest_hit"] = dict(
        name="closest_hit", ok=True, route="cuda",
        source="craytpu_torch/csrc/closest_hit.cu",
        replaces="craytpu/ops/flash2.py:185", launches=0,
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=None, bound_bytes_ms=t_bytes, bound_ops_ms=t_ops,
        visit_traffic_ms=max(t_vbytes, t_ops),
        visit_traffic_by="bytes" if t_vbytes >= t_ops else "operations")
    print(f"K2 closest_hit: B={B2} hits={hits} bit-equal to the plain "
          f"version (plain on CPU {plain_cpu_s:.1f} s); work: "
          f"{counts['inner']} inner visits, {counts['tri']} triangle tests, "
          f"{counts['sphere']} sphere tests, {n_nodes} nodes and {n_tris} "
          f"triangles read -> {ops:.3e} f32 ops, {nbytes / 1e6:.2f} MB; "
          f"kernel {ms:.4f} ms, plain on card {plain_ms:.2f} ms, bound "
          f"{max(t_bytes, t_ops):.4f} ms (bytes {t_bytes:.4f}, operations "
          f"{t_ops:.4f}), {100 * max(t_bytes, t_ops) / ms:.1f}% of it; "
          f"visit traffic at the HBM rate (each read counted: "
          f"{vbytes / 1e6:.2f} MB; not a bound, re-reads hit the L2) "
          f"{max(t_vbytes, t_ops):.4f} ms (bytes {t_vbytes:.4f}), "
          f"{100 * max(t_vbytes, t_ops) / ms:.1f}% of the kernel's time",
          flush=True)

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
    t_ops = B1 * K1_OPS_LANE / F32_LANE_OPS_PER_S * 1e3
    out["hitrec"] = dict(
        name="hitrec", ok=True, route="cuda",
        source="craytpu_torch/csrc/hitrec.cu",
        replaces="craytpu/ops/hitrec_kernel.py:37", launches=0,
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=None, bound_bytes_ms=t_bytes, bound_ops_ms=t_ops)
    print(f"K1 hitrec: B={B1} bit-equal to the plain version; work: "
          f"{n_trows} tri_wide and {n_irows} inst_wide rows read, "
          f"{nbytes / 1e6:.2f} MB, {B1 * K1_OPS_LANE:.3e} f32 ops; kernel "
          f"{ms:.4f} ms, plain on card {plain_ms:.2f} ms, bound "
          f"{max(t_bytes, t_ops):.4f} ms (bytes {t_bytes:.4f}, operations "
          f"{t_ops:.4f})", flush=True)

    # ---- K3 (the dense search) on K2's 2^16 mixed rays, against its
    # plain version on the card (on the CPU it would take minutes); then on
    # rays that graze the planes of its triangles, here and on a tilted
    # floor
    out["dense_hit"] = check_dense_kernel(torch, geom, cs_dev.dense, oc,
                                          dc, lc)
    check_graze(torch, cs_dev, *graze_batch(cs_cpu, 20261),
                "stress_highpoly")
    import pathlib
    import tempfile
    from tests.torch_dense_rays import floor_scene
    floor_cpu = floor_scene(pathlib.Path(tempfile.mkdtemp()))
    floor = floor_scene(pathlib.Path(tempfile.mkdtemp()), "cuda")
    check_graze(torch, floor, *graze_batch(floor_cpu, 20262, floor=True),
                "tilted floor")
    return out


def dense_cull_counts(torch, geom, dense, o, d, limit) -> dict:
    """K3's work on rays (o, d, limit) under its cull, from the plain cull
    model (dense_isect.dense_cull_plain) on the same tensors, at the
    kernel's lanes: ray r is lane r % 256 of block r // 256, warp r //
    32. Lane-level: root tests and votes; superblock tests (every
    superblock of an instance whose root the lane keeps) and votes; group
    tests (the groups of the superblocks it votes for) and votes; the
    pairs of the groups it votes for ("pairs_lane"). As the kernel runs
    them: superblocks its blocks load ("blocks_loaded", of "block_slots"
    a block could) and groups its warps run ("groups_run", of
    "group_slots", the groups of the superblocks their blocks load), and
    the pairs those warps evaluate ("pairs_run", a pair a lane).
    "pairs_all": every live pair; "uv_all": the live pairs whose t, as
    the pair test computes it, passes 0 <= t <= the ray's final best (the
    pairs that need u and v in any order of the triangles), "uv_lane"
    those of them in the groups their lanes vote for."""
    from craytpu_torch.ops import dense_isect as dx
    from craytpu_torch.ops import traverse as trv
    hit, culls = dx.dense_cull_plain(geom, dense, o, d, limit)
    B = o.shape[0]
    dev = o.device
    keys = ("root_tests", "root_kept", "block_tests", "block_votes",
            "blocks_loaded", "block_slots", "group_tests", "group_votes",
            "groups_run", "group_slots", "pairs_lane", "pairs_run",
            "pairs_all", "uv_all", "uv_lane")
    z = dict.fromkeys(keys, 0)
    live_lane = limit > 0
    z["live"] = live = int(live_lane.sum())
    plan = dense.plan.tolist()
    warp_lanes = torch.full(((B + 31) // 32,), 32, device=dev)
    warp_lanes[-1] = B - 32 * (warp_lanes.shape[0] - 1)

    def fold(x, k):  # (B, ...) bool -> (ceil(B / k), ...) any over k lanes
        pad = -B % k
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
        return x.view(-1, k, *x.shape[1:]).any(dim=1)
    for c in culls:
        n = plan[c["inst"]][2]
        root, block, group = c["root"], c["block"], c["group"]
        ng, nb = group.shape[1], block.shape[1]
        rows = torch.full((ng,), dx.GROUP, device=dev)
        rows[-1] = n - dx.GROUP * (ng - 1)
        sb = torch.arange(ng, device=dev) // dx.SUPER
        sb_groups = torch.bincount(sb, minlength=nb)
        root_blk = fold(root[:, None], 256)[:, 0]
        loaded = fold(block, 256) & root_blk[:, None]
        lane_loaded = loaded.repeat_interleave(256, dim=0)[:B]
        warp_run = fold(group & lane_loaded[:, sb], 32)
        z["root_tests"] += live
        z["root_kept"] += int(root.sum())
        z["block_tests"] += int(root.sum()) * nb
        z["block_votes"] += int(block.sum())
        z["blocks_loaded"] += int(loaded.sum())
        z["block_slots"] += int(root_blk.sum()) * nb
        z["group_tests"] += int((block.sum(0) * sb_groups).sum())
        z["group_votes"] += int(group.sum())
        z["groups_run"] += int(warp_run.sum())
        z["group_slots"] += int((loaded.sum(0) * sb_groups).sum()) * 8
        z["pairs_lane"] += int((group.sum(0) * rows).sum())
        z["pairs_run"] += int(((warp_run * rows).sum(1) * warp_lanes).sum())
        z["pairs_all"] += live * n
        # the pairs whose t passes 0 <= t <= the final best, all of them
        # and those of the voted groups
        first = plan[c["inst"]][1]
        oi, di = trv.object_ray(geom.inst_Ainv[c["inst"]],
                                geom.inst_offset[c["inst"]], o, d)
        wi = torch.linalg.cross(di, oi)  # only t is read
        step = max(dx.PLAIN_CHUNK_ELEMS // B // dx.TILE, 1) * dx.TILE
        for k in range(0, n, step):
            t, _ = dx.pair_tests(
                dense.leaf_table[first + k:first + min(k + step, n)], oi, di,
                wi)
            ok = (t >= 0.0) & (t <= hit.t[:, None]) & live_lane[:, None]
            z["uv_all"] += int(ok.sum())
            ok = torch.cat([ok, ok.new_zeros((B, -ok.shape[1] % dx.GROUP))],
                           1).view(B, -1, dx.GROUP).sum(2)
            g = group[:, k // dx.GROUP:k // dx.GROUP + ok.shape[1]]
            z["uv_lane"] += int((ok * g).sum())
    return z


def fmt_cull(z: dict) -> str:
    def share(a, b):
        return f"{100 * z[a] / max(z[b], 1):.3f}%"
    return (f"{z['live']} live lanes; root kept {share('root_kept', 'root_tests')}"
            f"; superblock votes {share('block_votes', 'block_tests')} of "
            f"the lanes' tests, blocks load {share('blocks_loaded', 'block_slots')}"
            f"; group votes {share('group_votes', 'group_tests')} of the "
            f"lanes' tests, warps run {share('groups_run', 'group_slots')}; "
            f"pairs tested {z['pairs_lane']:.4e} "
            f"({share('pairs_lane', 'pairs_all')} of {z['pairs_all']:.4e}), "
            f"evaluated by the warps {z['pairs_run']:.4e} "
            f"({share('pairs_run', 'pairs_all')}); box tests "
            f"{z['root_tests'] + z['block_tests'] + z['group_tests']:.4e}")


def dense_bound(dense, live: int, B: int, cull: dict,
                culled: bool) -> tuple:
    """K3's bound for B rays of which `live` are live, from the counts
    `cull` of dense_cull_counts: (bound ms, what bounds it, live
    ray-triangle pairs, {"bound_ops_ms", "bound_bytes_ms"}). Operations:
    the full search's (K3_OPS_T every live pair, K3_OPS_UV each that
    needs u and v, "uv_all"), or if
    `culled` the culled search's (K3_OPS_SLAB a box test and K3_OPS_PLANE
    more a box test the lane skips, K3_OPS_T a pair of the groups the
    lanes vote for and K3_OPS_UV each of those whose t passes,
    "uv_lane"); both a K2 sphere test a live ray
    and sphere instance, at the f32 lane rate; bytes: each ray's 7 input
    and 3 output words, the table and the plan once (and with `cull` the
    row ids and the boxes)."""
    from craytpu_torch.scene.device import INST_SPHERE
    plan = dense.plan.tolist()
    tris = sum(n for k, _, n, _ in plan if k != INST_SPHERE)
    sph = sum(1 for k, _, _, _ in plan if k == INST_SPHERE)
    pairs = live * tris
    nbytes = (B * (7 + 3) * 4 + dense.leaf_table.numel() * 4
              + dense.plan.numel() * 4)
    uv_pairs = cull["uv_all"]
    if not culled:
        ops = pairs * K3_OPS_T
    else:
        tests = (cull["root_tests"] + cull["block_tests"]
                 + cull["group_tests"])
        kept = cull["root_kept"] + cull["block_votes"] + cull["group_votes"]
        ops = (K3_OPS_SLAB * tests + K3_OPS_PLANE * (tests - kept)
               + K3_OPS_T * cull["pairs_lane"])
        uv_pairs = cull["uv_lane"]
        nbytes += 4 * (dense.leaf_ids.numel() + dense.root_box.numel()
                       + dense.block_box.numel() + dense.group_box.numel())
    ops += uv_pairs * K3_OPS_UV + live * sph * K2_OPS_SPHERE
    t_ops = ops / F32_LANE_OPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", pairs, {"bound_ops_ms": t_ops,
                                  "bound_bytes_ms": t_bytes})


def check_dense_kernel(torch, geom, dense, o, d, limit) -> dict:
    """K3 on CUDA rays (o, d, limit) bit-equal to its plain version on the
    same tensors, timed; the cull counters; its line of the kernels
    record (launches 0; bound_ms the culled search's; the full search's
    bound is printed)."""
    from craytpu_torch.ops import dense_isect as dx
    B = o.shape[0]
    got = dx.dense_hit(geom, o, d, limit, dense)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    want = dx.dense_hit_plain(geom, dense, o, d, limit)
    b.record()
    torch.cuda.synchronize()
    plain_ms = a.elapsed_time(b)
    bit_diff(got.inst, want.inst, "K3 inst")
    bit_diff(got.prim, want.prim, "K3 prim")
    err = bit_diff(got.t, want.t, "K3 t")
    ms = cuda_ms(lambda: dx.dense_hit(geom, o, d, limit, dense), 5)
    live = int((limit > 0).sum())
    cull = dense_cull_counts(torch, geom, dense, o, d, limit)
    uv = cull["uv_all"]
    full, _, pairs, _ = dense_bound(dense, live, B, cull, False)
    bound, by, _, parts = dense_bound(dense, live, B, cull, True)
    print(f"K3 dense_hit: B={B} ({live} live) bit-equal to the plain "
          f"version; {pairs:.3e} live ray-triangle pairs, {uv:.3e} of them "
          f"need u and v; kernel {ms:.4f} ms, plain on card "
          f"{plain_ms:.1f} ms; bound of the culled search {bound:.4f} ms "
          f"({by}, {100 * bound / ms:.1f}% of it), of the full search "
          f"{full:.3f} ms ({100 * full / ms:.1f}%); "
          f"{int((want.inst >= 0).sum())} hits", flush=True)
    print(f"K3 cull at B={B}: {fmt_cull(cull)}", flush=True)
    return dict(name="dense_hit", ok=True, route="cuda",
                source="craytpu_torch/csrc/dense_hit.cu",
                replaces="craytpu/ops/dense_isect.py:120", launches=0,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=None, **parts)


def graze_batch(cs_cpu, seed: int, floor: bool = False,
                B: int = 1024) -> tuple:
    """Rays that graze the planes of the first mesh's triangles
    (tests/torch_dense_rays.py::graze_rays): at 0, 1e-8, 1e-6, 1e-4 and
    1e-3 rad and up to THETA off a triangle's plane, through it and beside
    it, from 0.2-3 and 50-400 units; B a kind, on the 2% slivers and on
    any triangle (with `floor`, the tilted floor's triangles and, B more,
    rays in its plane beside it, which only rounding hits). CPU tensors
    (o, d, limit), every 9th lane dead."""
    import torch
    from tests.torch_dense_rays import floor_edge_rays, graze_rays
    rng = np.random.default_rng(seed)
    parts = [graze_rays(cs_cpu, rng, B, where, dist, share)
             for share in ((1.0,) if floor else (0.02, 1.0))
             for where in ("through", "beside")
             for dist in ((0.2, 3.0), (50.0, 400.0))]
    if floor:
        parts.append(floor_edge_rays(rng, B, (0.2, 3.0)))
    o = torch.from_numpy(np.concatenate([p[0] for p in parts]))
    d = torch.from_numpy(np.concatenate([p[1] for p in parts]))
    from craytpu_torch.ops import traverse as trv
    limit = torch.where(torch.arange(o.shape[0]) % 9 == 4, 0.0, trv.FLT_MAX)
    return o, d, limit


def check_graze(torch, cs, o, d, limit, what: str) -> None:
    """K3 on the card (cs on CUDA) against its plain version on the card,
    bit for bit on every lane of the grazing rays (o, d, limit) (CPU
    tensors), timed."""
    from craytpu_torch.ops import dense_isect as dx
    o, d, limit = o.cuda(), d.cuda(), limit.cuda()
    got = dx.dense_hit(cs.geom, o, d, limit, cs.dense)
    want = dx.dense_hit_plain(cs.geom, cs.dense, o, d, limit)
    for field in ("inst", "prim", "t"):
        bit_diff(getattr(got, field), getattr(want, field),
                 f"K3 {field} on the grazing rays of {what}")
    ms = cuda_ms(lambda: dx.dense_hit(cs.geom, o, d, limit, cs.dense), 3)
    print(f"K3 grazing rays of {what}: B={o.shape[0]} "
          f"({int((limit > 0).sum())} live) bit-equal to the plain version "
          f"on every lane; {int((want.inst >= 0).sum())} hits; kernel "
          f"{ms:.3f} ms", flush=True)


def phase_golden(torch) -> None:
    from craytpu_torch.models.wavefront_pt import WavefrontRenderer
    from craytpu_torch.ops import hitrec as hr
    from craytpu_torch.ops import traverse as trv
    from craytpu_torch.scene.compile import compile_scene
    from craytpu_torch.utils import golden

    for name in ("stress_highpoly", "stress_instances"):
        n_k2, n_k1 = trv.closest_hit.launches, hr.hitrec_record.launches
        cs = compile_scene(load(name, {"width": 80, "height": 50,
                                       "samples": 4}))
        ren = WavefrontRenderer(cs)
        fb = ren.render(4)
        if not (trv.closest_hit.launches > n_k2
                and hr.hitrec_record.launches > n_k1):
            fail(f"golden {name}: the render did not go through the "
                 "kernels")
        if not (ren.graphs.captures and ren.graphs.replays):
            fail(f"golden {name}: the render did not go through graphs")
        ok, within, mean_abs = golden.compare(fb, name, 80, 50, 4)
        print(f"golden {name} 80x50 4spp: within1lsb={within:.5f} "
              f"mean_abs={mean_abs:.4f} ok={ok}; CUDA graphs: "
              f"{ren.graphs.captures} captures, {ren.graphs.replays} "
              f"replays", flush=True)
        if not ok:
            fail(f"golden {name}")


def profile_frame(torch, frame, kernels=(), cpu: bool = True) -> dict:
    """One call of frame() under torch.profiler: device time per kernel
    name (ms), the whole device time, the frame's wall time, and for each
    name in `kernels` the device time of each of its launches (ms), in
    order. cpu=False traces the device alone (an eager frame's host ops
    are some 10^5 events, which take the profiler many seconds to
    process)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts) as prof:
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


def launch_counts() -> dict:
    """The kernel wrappers' launch counters, by wrapper name."""
    from craytpu_torch.ops import dense_isect as dx
    from craytpu_torch.ops import hitrec as hr
    from craytpu_torch.ops import traverse as trv
    return {"closest_hit": trv.closest_hit.launches,
            "hitrec": hr.hitrec_record.launches,
            "dense_hit": dx.dense_hit.launches}


def print_frame_profile(torch, frame, names=KERNEL_NAMES) -> dict:
    """A profiled frame(): each kernel's launches (its wrapper's count,
    graph replays included) and kernel events and device time (the
    profiler sees the kernels inside a replay), then the whole
    device-time breakdown and the device's busy share. names: wrapper
    name -> kernel name, of the kernels the frame launches. Returns the
    profile (profile_frame), with "counted": wrapper name -> (its
    wrapper's count, the profiler's kernel events) in this frame."""
    before = launch_counts()
    prof = profile_frame(torch, frame, names.values())
    after = launch_counts()
    by_name = prof["by_name"]
    prof["counted"] = {}
    for name, k in names.items():
        dev = prof["launches"][k]
        prof["counted"][name] = (after[name] - before[name], len(dev))
        total = sum(ms for key, (ms, _) in by_name.items() if k in key)
        mean = f", mean {total / len(dev):.4f} ms" if dev else ""
        print(f"  {name}: per frame {after[name] - before[name]} launches "
              f"(wrapper count), {len(dev)} kernel events, {total:.2f} ms "
              f"device time (profiler{mean}, min "
              f"{min(dev, default=0.0):.4f}, max {max(dev, default=0.0):.4f})",
              flush=True)
    print(f"profiled frame: wall {prof['wall_ms']:.1f} ms, device busy "
          f"{prof['device_ms']:.1f} ms "
          f"({100 * prof['device_ms'] / prof['wall_ms']:.1f}%; "
          f"{len(by_name)} kernel names); top device kernels:", flush=True)
    for key, (ms, n) in sorted(by_name.items(),
                               key=lambda kv: -kv[1][0])[:12]:
        print(f"    {ms:9.2f} ms {n:6d}x  {key[:90]}", flush=True)
    return prof


def profiled_replays(torch, label: str, frame, names,
                     attempts: int = 3) -> dict:
    """print_frame_profile of a graph frame, whose wrapper counts are
    added per replay from what each capture counted: the profiler's
    kernel events of each kernel in `names` must equal its wrapper's
    count. The profiler (CUPTI) now and then loses a run of records,
    which shows as fewer events of every kind (seen on an H100: one frame
    with 90 of its 91 K2 and K1 launches and 22,100 of its 22,448 float
    adds), so a frame with fewer events is profiled again, up to
    `attempts` frames in all. Fails at once on more events than counted
    or on a kernel not launched, and when no frame agrees. Returns the
    agreeing frame's profile."""
    seen = []
    for i in range(attempts):
        print(f"graphs {label}: profiled graph frame ({i + 1} of at most "
              f"{attempts}):", flush=True)
        prof = print_frame_profile(torch, frame, names)
        counted = prof["counted"]
        seen.append(counted)
        if any(e > c or not c for c, e in counted.values()):
            fail(f"graphs {label}: kernel events (profiler) against wrapper "
                 f"counts (count, events): {counted}")
        if all(c == e for c, e in counted.values()):
            return prof
        print(f"graphs {label}: the profiler lost records (count, events): "
              f"{counted}; profiling again", flush=True)
    fail(f"graphs {label}: no profiled frame's kernel events equal the "
         f"wrapper counts (count, events): {seen}")


def persistent_frame(ren, spp: int):
    """A persistent frame of ren, kept on the card."""
    return ren.render_persistent(spp, fetch=False)


def per_pass_frame(ren, spp: int):
    """A per-pass frame of ren (render_pass x spp), kept on the card."""
    import torch
    accum = torch.zeros((ren.height, ren.width, 4), device=ren.device)
    for p in range(spp):
        accum = ren.render_pass(accum, p, spp)
    return accum


@contextlib.contextmanager
def host_timer(ren, name: str):
    """Host seconds and calls of ren.<name> (no synchronisation: the time
    to queue the dispatch, or to wait where the queue is full)."""
    fn = getattr(ren, name)
    acc = {"n": 0, "s": 0.0}

    def timed(*a):
        t0 = time.perf_counter()
        out = fn(*a)
        acc["s"] += time.perf_counter() - t0
        acc["n"] += 1
        return out
    setattr(ren, name, timed)
    try:
        yield acc
    finally:
        delattr(ren, name)


def capture_seconds(ren) -> dict:
    """Host seconds of each graph capture (its key's first call: the
    warm-up run and the capture) in ren's kept frame records, by key."""
    out: dict = {}
    for rec in ren.trace.frames:
        for s in rec["spans"]:
            if s["name"] == "graph.capture":
                k = tuple(s["key"])
                out[k] = out.get(k, 0.0) + (s["t1_ms"] - s["t0_ms"]) / 1e3
    return out


def key_name(key: tuple) -> tuple:
    """A graph's key without the context and buffer addresses GraphCache
    adds."""
    return tuple(x for x in key if not isinstance(x, tuple)
                 and not (isinstance(x, int) and x >= 1 << 40))


def same_bits(torch, a, b) -> int:
    """How many values of two f32 frames on the card differ in their
    bits."""
    return int((a.view(torch.int32) != b.view(torch.int32)).sum())


def graph_vs_eager(torch, label: str, make, frame, spp: int = SPP,
                   names=KERNEL_NAMES, host_fn: str = "_pool_step",
                   rounds: int = 2) -> dict:
    """The forward path `frame(ren, spp)` through CUDA graphs against the
    eager path, on renderers make(True) and make(False) of one compiled
    scene: each one's first frame (the graph renderer's captures, their
    count and the seconds of each key), a counted frame of each (graph
    replays and captures, the wrappers' launches, the replays' share of
    them, host ms a dispatch of host_fn, peak device memory), bit
    equality (graph frame == eager frame, graph frame == graph frame),
    paths/s in turns (graphs, eager, eager, graphs) x rounds, and a
    profiled frame of each (device busy share; the graph frame's kernel
    breakdown). Fails unless the frames are bit-equal, the kernels of
    `names` launched in the graph frame only through replays, and the
    profiled graph frame's kernel events of each equal its wrapper's
    count."""
    rens = {"graphs": make(True), "eager": make(False)}
    out = {"label": label, "spp": spp}
    # the first frames traced (CRAYTPU_TRACE=1): the captures' spans
    os.environ["CRAYTPU_TRACE"] = "1"
    try:
        for name, ren in rens.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frame(ren, spp)
            torch.cuda.synchronize()
            out[f"first_s_{name}"] = time.perf_counter() - t0
    finally:
        del os.environ["CRAYTPU_TRACE"]
    st = rens["graphs"].trace.snapshot()
    caps = capture_seconds(rens["graphs"])
    out["captures_first"] = st["captures"]
    print(f"graphs {label}: first frame {out['first_s_graphs']:.2f} s with "
          f"{st['captures']} captures (eager first frame "
          f"{out['first_s_eager']:.2f} s); seconds of each key's first "
          f"call (warm-up run + capture): " + ", ".join(
              f"{key_name(k)} {v:.3f}" for k, v in sorted(
                  caps.items(), key=lambda kv: -kv[1])), flush=True)
    frames = {}
    for name, ren in rens.items():
        before, c0 = ren.trace.snapshot(), launch_counts()
        torch.cuda.reset_peak_memory_stats()
        with host_timer(ren, host_fn) as acc:
            t0 = time.perf_counter()
            frames[name] = frame(ren, spp)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        after, c1 = ren.trace.snapshot(), launch_counts()
        n = {k: c1[k] - c0[k] for k in c0}
        rep = {k: after["replayed"].get(k if k != "hitrec" else
                                        "hitrec_record", 0)
               - before["replayed"].get(k if k != "hitrec" else
                                        "hitrec_record", 0) for k in c0}
        out[name] = dict(
            replays=after["replays"] - before["replays"],
            captures=after["captures"] - before["captures"],
            launches=n, replayed=rep, peak=torch.cuda.max_memory_allocated(),
            host_ms=1e3 * acc["s"] / max(acc["n"], 1), dispatches=acc["n"],
            secs=secs)
        o = out[name]
        print(f"graphs {label} {name}: {o['replays']} replays, "
              f"{o['captures']} captures a frame; launches "
              f"{ {k: v for k, v in n.items() if v} } (through replays "
              f"{ {k: v for k, v in rep.items() if v} }); {host_fn} "
              f"{acc['n']}x, host {o['host_ms']:.3f} ms each; peak device "
              f"memory {o['peak'] / 2**30:.3f} GiB; {secs:.2f} s",
              flush=True)
    g = out["graphs"]
    if g["captures"] or not g["replays"] or any(
            g["launches"][k] != g["replayed"][k] or not g["launches"][k]
            for k in names):
        fail(f"graphs {label}: the graph frame did not run its kernels "
             f"through replays only: {g}")
    again = frame(rens["graphs"], spp)
    diff = {"graph vs eager": same_bits(torch, frames["graphs"],
                                        frames["eager"]),
            "graph vs graph": same_bits(torch, frames["graphs"], again)}
    out["bits"] = diff
    print(f"graphs {label}: values that differ in their bits of "
          f"{frames['graphs'].numel()}: {diff}", flush=True)
    if any(diff.values()):
        fail(f"graphs {label}: frames not bit-equal: {diff}")
    fb = frames["graphs"]
    if not bool(torch.isfinite(fb).all()) or not float(fb[..., :3].max()) > 0:
        fail(f"graphs {label}: the frame is not finite or is black")
    del frames, again, fb
    rates = {"graphs": [], "eager": []}
    for _ in range(rounds):
        for name in ("graphs", "eager", "eager", "graphs"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frame(rens[name], spp)
            torch.cuda.synchronize()
            rates[name].append(W * H * spp / (time.perf_counter() - t0))
    out["paths_s"] = rates
    ratio = float(np.median(rates["graphs"]) / np.median(rates["eager"]))
    out["ratio"] = ratio
    print(f"graphs {label}: paths/s in turns (graphs, eager, eager, "
          f"graphs) x{rounds}: {fmt_rates(rates)}; graphs/eager {ratio:.3f}",
          flush=True)
    busy = {}
    for name in ("eager", "graphs"):
        ren = rens[name]
        if name == "graphs":
            prof = profiled_replays(torch, label, lambda: frame(ren, spp),
                                    names)
            out["counted"] = prof["counted"]
        else:
            prof = profile_frame(torch, lambda: frame(ren, spp), cpu=False)
        busy[name] = (prof["device_ms"], prof["wall_ms"])
    out["busy"] = busy
    print(f"graphs {label}: device busy under the profiler: " + "; ".join(
        f"{k} {d:.1f} of {w:.1f} ms ({100 * d / w:.1f}%)"
        for k, (d, w) in busy.items()), flush=True)
    return out


def check_flush(torch) -> dict:
    """The framebuffer flush (wavefront_pt._scatter_add: index_put_ with
    accumulate=True) on the card: 2^20 rows into 2^18 pixels (about four
    a pixel) give the same bits in three runs and the same bits as the
    CPU's (which adds a pixel's rows one after another, as the JAX
    package's CPU scatter does); and the order of the adds, read from
    rows of 2^-24 added to 1.0, whose sum depends on it (1 + e + e is 1
    one add after another, 1 + (e + e) is 1 + 2^-23). index_add_'s
    atomics, the flush before, are run beside it."""
    from craytpu_torch.models.wavefront_pt import _scatter_add
    rng = np.random.default_rng(20264)
    n, npix = 1 << 20, 1 << 18
    lane = torch.from_numpy(rng.integers(0, npix, n).astype(np.int32))
    delta = torch.from_numpy(rng.random((n, 4)).astype(np.float32))
    want = torch.zeros((npix, 4))
    _scatter_add(want, lane, delta)
    lc, dc = lane.cuda(), delta.cuda()
    runs, atomics = [], []
    for _ in range(3):
        f = torch.zeros((npix, 4), device="cuda")
        _scatter_add(f, lc, dc)
        runs.append(f.cpu())
        f = torch.zeros((npix, 4), device="cuda")
        f.index_add_(0, lc.long(), dc)
        atomics.append(f.cpu())
    det = [same_bits(torch, runs[0], r) for r in runs[1:]]
    cpu = same_bits(torch, runs[0], want)
    ia = [same_bits(torch, atomics[0], r) for r in atomics[1:]]
    one = torch.ones((3, 4), device="cuda")
    e = torch.full((6, 4), 2.0 ** -24, device="cuda")
    _scatter_add(one, torch.tensor([0, 0, 1, 1, 1, 2], device="cuda"), e)
    got = one[:, 0].cpu().tolist()
    order = ("one after another" if got == [1.0, 1.0, 1.0]
             else "rows summed first" if got[0] == 1.0 + 2.0 ** -23
             else f"other {got}")
    print(f"flush: index_put_(accumulate=True) on the card, 2^20 rows into "
          f"2^18 pixels: values that differ from run 1 in runs 2-3: {det}, "
          f"from the CPU's: {cpu}; a pixel's rows added {order} "
          f"(1.0 + 2^-24 x 2, x 3, x 1 -> {got}); index_add_'s atomics, "
          f"runs 2-3 against run 1: {ia}", flush=True)
    if any(det):
        fail(f"flush: not deterministic on the card: {det}")
    return {"differ": det, "cpu": cpu, "order": order, "atomics": ia}


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
    kernels.setdefault("graphs", {})["per-pass"] = graph_vs_eager(
        torch, "per-pass 1080p", lambda g: WavefrontRenderer(
            r.compiled, graphs=g), per_pass_frame, host_fn="_multi_step")


def frame_persistent(torch, ren) -> float:
    """One persistent frame of ren (persistent_frame at SPP): wall
    seconds to its end."""
    t0 = time.perf_counter()
    persistent_frame(ren, SPP)
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
        ren = make_renderer(cs)
        fb = ren.render_persistent(4)
        if not (trv.closest_hit.launches > n_k2
                and hr.hitrec_record.launches > n_k1):
            fail(f"persistent golden {name}: the render did not go "
                 "through the kernels")
        if not (ren.graphs.captures and ren.graphs.replays):
            fail(f"persistent golden {name}: the render did not go "
                 "through graphs")
        ok, within, mean_abs = golden.compare(fb, name, 80, 50, 4)
        print(f"persistent golden {name} 80x50 4spp: within1lsb="
              f"{within:.5f} mean_abs={mean_abs:.4f} ok={ok}; CUDA graphs: "
              f"{ren.graphs.captures} captures, {ren.graphs.replays} "
              f"replays", flush=True)
        if not ok:
            fail(f"persistent golden {name}")

    # ---- the flush's order and determinism on the card
    kernels["flush"] = check_flush(torch)

    # ---- interrupt at the 3rd poll, checkpoint to disk, resume: equal to
    # the uninterrupted render up to accumulation order (a resumed path's
    # radiance adds into another sum), rtol=2e-5, atol=2e-6. k=1 keeps
    # paths in flight.
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

    del ren
    # ---- graph against eager, the persistent frame (the CLI's path)
    kernels.setdefault("graphs", {})["persistent"] = graph_vs_eager(
        torch, "persistent 1080p", lambda g: make_renderer(cs, graphs=g),
        persistent_frame)
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
    out, n_k2, n_k1, _ = counted_all(fn)
    return out, n_k2, n_k1


def counted_all(fn) -> tuple:
    """(fn(), K2, K1 and K3 launches): the counters set to 0 just before
    fn and read just after."""
    from craytpu_torch.ops import dense_isect as dx
    from craytpu_torch.ops import hitrec as hr
    from craytpu_torch.ops import traverse as trv
    trv.closest_hit.launches = 0
    hr.hitrec_record.launches = 0
    dx.dense_hit.launches = 0
    out = fn()
    return (out, trv.closest_hit.launches, hr.hitrec_record.launches,
            dx.dense_hit.launches)


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
    for r in (ren_n, ren_p):        # warm-up: each renderer's captures
        frame_persistent(torch, r)
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
    for _ in range(1):
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
    del ren_n, ren_p
    kernels.setdefault("graphs", {})["nee"] = graph_vs_eager(
        torch, "NEE persistent 1080p", lambda g: make_renderer(
            cs, nee=True, graphs=g), persistent_frame)

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


def cluster_session(name: str, overrides: dict, node: str,
                    bounces: int | None = None):
    """Load a scene as the CLI's master does (its assets recorded) and
    ship it to the worker at `node`: (scene, scene renderer, clients).
    bounces: a path depth written into the scene's JSON in place of its
    own (the master and the worker both read it)."""
    from craytpu_torch.parallel import cluster
    from craytpu_torch.parallel.pool_shard import make_renderer
    from craytpu_torch.scene.compile import compile_scene
    from craytpu_torch.scene.sceneloader import load_scene_from_buf
    from craytpu_torch.utils import fileio
    path = os.path.join(REPO, "assets", f"{name}.json")
    assets = fileio.start_recording()
    text = fileio.load_file(path, text=True)
    if bounces is not None:
        data = json.loads(text)
        data["renderer"]["bounces"] = bounces
        text = json.dumps(data)
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


# phase 9's 1080p clustered frames trace this many bounces (the scene's
# own 12 cut to 6), and their turns fit about this many seconds: at 12
# bounces a master-alone frame alone took about 80 s on the H100, and
# the script keeps to half its 1200 s limit
CLUSTER_BOUNCES = 6
CLUSTER_FRAMES_S = 30.0


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

        # ---- the 1080p frame: one session, a startRender a frame, at
        # CLUSTER_BOUNCES (the tile path's time grows with
        # the bounces; the phase keeps its frames near 30 s)
        t1 = time.perf_counter()
        scene, r, clients = cluster_session(
            "stress_highpoly", {"width": W, "height": H, "samples": SPP},
            node, bounces=CLUSTER_BOUNCES)
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
        # frames' time for the turns below) stay under CLUSTER_FRAMES_S
        est = {s: tile_s * len(tiles) * s for s in (4, 2, 1)}
        spp = next((s for s in (4, 2, 1)
                    if 3.2 * est[s] <= CLUSTER_FRAMES_S), 1)
        turns = (["alone", "worker", "worker", "alone"]
                 if 3.2 * est[spp] <= CLUSTER_FRAMES_S
                 else ["alone", "worker"])
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
    """Phase 10: the live preview, --trace, debug mode, the frame record
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
    ren.render_persistent(SPP)                                # warm-up

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
    with open(os.path.join(tdir, "trc", "stress_highpoly_frames.json")) as f:
        recs = json.load(f)["frames"]
    if not (recs and recs[-1]["profiled"] and recs[-1]["counts"]["steps"]):
        fail("--trace: no profiled frame record with pool steps")
    done = [ln for ln in res.stdout.splitlines() if "Finished" in ln]
    print(f"trace: CLI {' '.join(cmd[3:])}: exit 0 in {cli_s:.1f} s "
          f"(process start, scene load, profiler start and export "
          f"included); {done[-1] if done else ''}; trace "
          f"{len(blob) / 1e6:.1f} MB, kernel events "
          f"{names}; frame record: {recs[-1]['counts']['steps']} steps, "
          f"device ms {recs[-1]['device_ms']}", flush=True)
    del blob

    # ---- debug mode (eager, a check a bounce): the clean frame unchanged
    # bit for bit, per pass and persistent (the flush adds without
    # atomics, in a fixed order), its cost; a NaN albedo and an
    # out-of-range id raise.
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
        if bits["per-pass"] or bits["persistent"]:
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

    # ---- the frame record: its counts equal phase 5's; device ms by kind
    os.environ["CRAYTPU_TRACE"] = "1"
    try:
        t0 = time.perf_counter()
        ren.render_persistent(SPP, fetch=False)
        traced_s = time.perf_counter() - t0
        st = ren.trace.last
    finally:
        del os.environ["CRAYTPU_TRACE"]
    c = st["counts"]
    want = (pool_calls["_pool_step"], pool_calls["_flush_pack_refill"]
            + pool_calls["_flush_pack_refill_host"],
            pool_calls["_pack_shrink"])
    got = (c["steps"], c.get("refills", 0), c.get("shrinks", 0))
    if got != want:
        fail(f"frame record {got} (steps, refills, shrinks) differs from "
             f"phase 5's counts {want}")
    if c["captures"]:
        fail(f"frame record: tracing captured {c['captures']} graphs")
    gaps = sorted(st["gaps"], key=lambda g: -g["ms"])[:3]
    print(f"frame record (CRAYTPU_TRACE=1): {got[0]} steps, {got[1]} "
          f"refills, {got[2]} shrinks (= phase 5), occupancy "
          f"{st['occupancy']:.3f}, {st['bounces_per_path']:.3f} "
          f"lane-bounces a path; frame {traced_s:.2f} s; device ms "
          + ", ".join(f"{k} {v:.2f}" for k, v in sorted(
              st["device_ms"].items(), key=lambda kv: -kv[1]))
          + "; longest gaps " + ", ".join(
              f"{g['ms']:.2f} ms in {g['span']} before {g['before']}"
              for g in gaps), flush=True)

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


def interrupt_at(n: int):
    """An interrupt callable that fires at its n-th poll."""
    polls = []

    def interrupt():
        polls.append(1)
        return len(polls) >= n
    return interrupt


def digest(a) -> str:
    import hashlib
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def step_close(got, want, mu) -> float:
    """Fail-free check of an updated theta against another: the largest
    |d| of any table over the entries whose gradient (mu / 0.1 after one
    Adam step) exceeds 1e-3 of its table's largest (elsewhere the first
    step moves an entry by about +-lr with the sign of noise)."""
    from dataclasses import fields
    worst = 0.0
    for f in fields(want):
        g = getattr(mu, f.name).abs()
        if float(g.max()) == 0.0:
            continue
        sel = g > 1e-3 * g.max()
        d = (getattr(got, f.name) - getattr(want, f.name)).abs()[sel]
        worst = max(worst, float(d.max()) if d.numel() else 0.0)
    return worst


def shard_rank() -> dict:
    """One rank of phase 11's group of 2 (gloo, both ranks on this card):
    the 1080p persistent frame of ShardedPoolRenderer (launches counted
    on each rank), paths/s of 2 ranks and of 1 rank (rank 0 alone, rank 1
    waiting) in turns, an interrupt at the 3rd poll on entry_scene, and
    the material train step on a (1, 2) mesh in turns with the one-card
    step. Returns rank 0's numbers and each rank's launches and digest."""
    import torch
    import torch.distributed as tdist

    from craytpu_torch.models.wavefront_pt import WavefrontRenderer
    from craytpu_torch.ops import hitrec as hr
    from craytpu_torch.ops import traverse as trv
    from craytpu_torch.parallel import dist, shard
    from craytpu_torch.parallel.pool_shard import make_renderer
    from craytpu_torch.scene.compile import compile_scene
    rank = dist.rank()
    out = {"rank": rank, "backend": tdist.get_backend()}
    cs = compile_scene(load("stress_highpoly", {"width": W, "height": H,
                                                "samples": SPP}))
    r = make_renderer(cs)
    out["renderer"] = (type(r).__name__, r.D, r.n_cards)
    single = WavefrontRenderer(cs)

    def frame(kind) -> float:
        tdist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if kind == "2 ranks":
            r.render_persistent(SPP, fetch=False)
        elif rank == 0:
            single.render_persistent(SPP, fetch=False)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        tdist.barrier()
        return dt

    frame("2 ranks")                                         # warm-up
    frame("1 rank")
    trv.closest_hit.launches = 0
    hr.hitrec_record.launches = 0
    fb = r.render_persistent(SPP)
    out["launches"] = (trv.closest_hit.launches, hr.hitrec_record.launches)
    out["digest"] = digest(fb)
    if rank == 0:
        out["frame"] = fb
    rates = {"2 ranks": [], "1 rank": []}
    for _ in range(2):
        for kind in ("2 ranks", "1 rank", "1 rank", "2 ranks"):
            rates[kind].append(W * H * SPP / frame(kind))
    out["rates"] = rates

    # ---- a 2-rank interrupt (k=1, paths in flight): the checkpoint
    os.environ["CRAYTPU_POOL_K"] = "1"
    try:
        rs = make_renderer(compile_scene(load("entry_scene", {})),
                           tile_rays=8192)
        ck = rs.render_persistent(3, interrupt=interrupt_at(3))
    finally:
        del os.environ["CRAYTPU_POOL_K"]
    out["ckpt"] = ck[1:]

    # ---- the material step on a (1, 2) mesh and on one card, in turns;
    # the first 2^20 pixels of the 1080p tile schedule, target 0.8 x a
    # render of them (made on rank 0 and broadcast)
    mesh = shard.make_mesh(2, n_sample=1)
    xs_all, ys_all, _, _ = single._pixel_schedule
    B = min(1 << 20, xs_all.shape[0])
    xs, ys = xs_all[:B], ys_all[:B]
    with torch.no_grad():
        target = shard.make_sharded_render_fn(single)(
            cs.params, xs, ys, 7)[..., :3] * 0.8
    tdist.broadcast(target, 0)
    steps = {"(1, 2) mesh": shard.make_train_step(single, mesh,
                                                  learning_rate=5e-3),
             "one card": shard.make_train_step(single, 1,
                                               learning_rate=5e-3)}
    results = {}

    def train(kind) -> float:
        step, init = steps[kind]
        tdist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if kind == "(1, 2) mesh" or rank == 0:
            theta, state, loss = step(cs.params, init(cs.params), xs, ys,
                                      target, 0)
            results[kind] = (theta, state, float(loss))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        tdist.barrier()
        return dt

    train("(1, 2) mesh")                                     # warm-ups
    train("one card")
    times = {"(1, 2) mesh": [], "one card": []}
    for kind in ("(1, 2) mesh", "one card", "one card", "(1, 2) mesh"):
        times[kind].append(train(kind))
    out["train_s"] = times
    th_m, st_m, loss_m = results["(1, 2) mesh"]
    out["train_digest"] = digest(th_m.colors.cpu().numpy())
    if rank == 0:
        th_1, st_1, loss_1 = results["one card"]
        out["train"] = {"loss": (loss_m, loss_1),
                        "theta_d": step_close(th_m, th_1, st_1.mu)}
    return out


def phase_shard(torch, kernels: dict) -> None:
    """Phase 11: the renderer and the train step over a process group
    (parallel/dist.py, pool_shard.py, shard.py) on this one card: a
    1-rank NCCL group in this process, then a 2-rank gloo group sharing
    the card, the 2-rank CLI, and dryrun_multichip(2)."""
    import torch.distributed as tdist

    from craytpu_torch.entry import dryrun_multichip
    from craytpu_torch.io.png import read_png_rgb
    from craytpu_torch.models.wavefront_pt import WavefrontRenderer
    from craytpu_torch.parallel import cluster, dist
    from craytpu_torch.parallel.pool_shard import ShardedPoolRenderer
    from craytpu_torch.runtime.tile import quantize_image
    from craytpu_torch.scene.compile import compile_scene
    from craytpu_torch.utils import golden

    # ---- a 1-rank NCCL group: the frame and a tile through render_ids
    t0 = time.perf_counter()
    dist.init_distributed(f"127.0.0.1:{free_port()}", 1, 0)
    try:
        backend = tdist.get_backend()
        cs = compile_scene(load("stress_highpoly", {"width": W, "height": H,
                                                    "samples": SPP}))
        single = WavefrontRenderer(cs)
        one = ShardedPoolRenderer(cs)
        one.render_persistent(SPP, fetch=False)              # warm-up
        want = single.render_persistent(SPP)
        frame1 = one.render_persistent(SPP)
        err = float(np.max(np.abs(frame1 - want)))
        print(f"shard: 1-rank {backend} group: ShardedPoolRenderer(D="
              f"{one.D}) 1080p frame vs the single-card frame max |d| "
              f"{err:.3e}", flush=True)
        if not np.allclose(frame1, want, rtol=2e-5, atol=2e-6):
            fail("1-rank sharded frame differs from the single-card frame")
        p = cs.prefs
        tw, th = min(p.tile_width, W), min(p.tile_height, H)
        tiles = quantize_image(W, H, tw, th, p.tile_order)
        t = tiles[len(tiles) // 2]
        tile = {"begin_x": t.begin_x, "begin_y": t.begin_y,
                "end_x": t.end_x, "end_y": t.end_y}
        tile_ms = {}
        got = {}
        for name, ren in (("render_ids", one), ("eager", single)):
            got[name] = cluster.render_tile(ren, tile, SPP, tw, th)  # warm
            torch.cuda.synchronize()
            ts = []
            for _ in range(3):
                t1 = time.perf_counter()
                cluster.render_tile(ren, tile, SPP, tw, th)
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t1) * 1e3)
            tile_ms[name] = ts
        err = float(np.max(np.abs(got["render_ids"] - got["eager"])))
        print(f"shard: a {tw}x{th} tile at {SPP} spp: render_ids "
              f"{' '.join(f'{x:.2f}' for x in tile_ms['render_ids'])} ms, "
              f"eager render_tile "
              f"{' '.join(f'{x:.2f}' for x in tile_ms['eager'])} ms; "
              f"max |d| {err:.3e}", flush=True)
        if not np.allclose(got["render_ids"], got["eager"], rtol=2e-5,
                           atol=2e-6):
            fail("render_ids tile differs from render_tile's eager path")
        del one, single, cs
    finally:
        tdist.destroy_process_group()
    torch.cuda.empty_cache()
    print(f"shard: 1-rank part {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- a 2-rank gloo group sharing this card
    t0 = time.perf_counter()
    outs = dist.spawn_local(2, shard_rank, timeout_s=400,
                            collective_timeout_s=300)
    r0 = outs[0]
    print(f"shard: 2-rank group ({r0['backend']}, renderer "
          f"{r0['renderer']}) took {time.perf_counter() - t0:.1f} s",
          flush=True)
    if r0["renderer"][:2] != ("ShardedPoolRenderer", 2):
        fail(f"2-rank make_renderer gave {r0['renderer']}")
    if len({o["digest"] for o in outs}) != 1:
        fail("the ranks hold different frames")
    n_k2 = [o["launches"][0] for o in outs]
    n_k1 = [o["launches"][1] for o in outs]
    if min(n_k2) == 0 or min(n_k1) == 0:
        fail(f"2-rank frame launches: closest_hit {n_k2}, hitrec {n_k1}")
    kernels["closest_hit"]["launches_sharded"] = n_k2
    kernels["hitrec"]["launches_sharded"] = n_k1
    err = float(np.max(np.abs(r0["frame"] - frame1)))
    print(f"shard: 2-rank 1080p {SPP}spp frame: launches per rank "
          f"closest_hit {n_k2}, hitrec {n_k1}; vs the 1-rank frame max "
          f"|d| {err:.3e}; every rank's frame equal", flush=True)
    if not np.allclose(r0["frame"], frame1, rtol=2e-5, atol=2e-6):
        fail("2-rank frame differs from the 1-rank frame")
    med = {k: float(np.median(v)) for k, v in r0["rates"].items()}
    print(f"shard: paths/s in turns (2 ranks, 1 rank, 1 rank, 2 ranks, "
          f"x2): {fmt_rates(r0['rates'])}; ratio of medians "
          f"{med['2 ranks'] / med['1 rank']:.3f}", flush=True)

    # the 2-rank checkpoint resumed on 1 rank
    fs, pend, ranges = r0["ckpt"]
    os.environ["CRAYTPU_POOL_K"] = "1"
    try:
        r1 = WavefrontRenderer(compile_scene(load("entry_scene", {})),
                               tile_rays=8192)
        ref = r1.render_persistent(3)
        resumed = r1.render_persistent(3, resume={
            "final_sum": fs, "pending": pend, "ranges": ranges})
    finally:
        del os.environ["CRAYTPU_POOL_K"]
    err = float(np.max(np.abs(resumed - ref)))
    print(f"shard: 2-rank interrupt at poll 3 ({len(pend)} paths in "
          f"flight, {len(ranges)} ranges) resumed on 1 rank: max |d| "
          f"{err:.3e}", flush=True)
    if len(pend) == 0 or not np.allclose(resumed, ref, rtol=2e-5,
                                         atol=2e-6):
        fail("the 2-rank checkpoint did not resume on 1 rank")

    tr = r0["train"]
    ts = r0["train_s"]
    print(f"shard: material train step, 2^20 pixels: (1, 2) mesh "
          f"{' '.join(f'{x:.3f}' for x in ts['(1, 2) mesh'])} s, one card "
          f"{' '.join(f'{x:.3f}' for x in ts['one card'])} s; loss "
          f"{tr['loss'][0]:.7g} vs {tr['loss'][1]:.7g}; max |d theta| "
          f"{tr['theta_d']:.3e} where the gradient counts", flush=True)
    if len({o["train_digest"] for o in outs}) != 1:
        fail("the ranks took different train steps")
    if not (np.isclose(tr["loss"][0], tr["loss"][1], rtol=1e-5, atol=0)
            and tr["theta_d"] <= 1e-6):
        fail("the (1, 2) mesh step differs from the one-card step")

    # ---- the goldens through the 2-rank CLI (both scenes at once)
    t0 = time.perf_counter()
    procs = []
    for name in ("stress_highpoly", "stress_instances"):
        d = os.path.join(REPO, "build", "chip_smoke", f"shard_cli_{name}")
        os.makedirs(d, exist_ok=True)
        port = free_port()
        for i in range(2):
            env = dict(cli_env(), CRAYTPU_COORDINATOR=f"127.0.0.1:{port}",
                       CRAYTPU_NUM_PROCESSES="2", CRAYTPU_PROCESS_ID=str(i))
            procs.append((name, d, subprocess.Popen(
                [sys.executable, "-m", "craytpu_torch",
                 os.path.join(REPO, "assets", f"{name}.json"), "-s", "4",
                 "-d", "80x50"], cwd=d, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
    try:
        logs = [p.communicate(timeout=300)[0] for _, _, p in procs]
    finally:
        for _, _, p in procs:
            if p.poll() is None:
                p.kill()
    for (name, d, p), log in zip(procs, logs):
        if p.returncode != 0:
            fail(f"2-rank CLI {name} exited {p.returncode}: {log[-2000:]}")
    for name, d, _ in procs[::2]:
        pngs = sorted(os.listdir(os.path.join(d, "output")))
        if pngs != [f"{name}_0000.png"]:
            fail(f"2-rank CLI {name} wrote {pngs}")
        ok, within, mean_abs = golden.compare_u8(
            read_png_rgb(os.path.join(d, "output", pngs[0])),
            read_png_rgb(os.path.join(REPO, "goldens", f"{name}_80_4.png")))
        print(f"shard: golden {name} 80x50 4spp through the 2-rank CLI: "
              f"within1lsb={within:.5f} mean_abs={mean_abs:.4f} ok={ok}",
              flush=True)
        if not ok:
            fail(f"2-rank CLI golden {name}")
    print(f"shard: 2-rank CLI goldens {time.perf_counter() - t0:.1f} s",
          flush=True)

    # ---- the entry point: dryrun_multichip(2) on this card
    t0 = time.perf_counter()
    summary = dryrun_multichip(2)
    print(f"shard: dryrun_multichip(2) {summary} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


# phase 12's three dense 1080p frames (the CLI's and two in turns with
# the walk's) are kept near this many seconds by the spp they run at
DENSE_FRAMES_S = 50.0


def phase_dense(torch, kernels: dict) -> None:
    """Phase 12: CRAYTPU_TRAVERSAL=dense, the dense search (K3) in place of
    the walk (K2): K3's winners against K2's on the 1080p frame's first
    primary batch, the goldens per pass and persistent, the CLI, the
    persistent 1080p frame in turns with the walk's, and a diff_geometry
    gradient against the walk's."""
    from craytpu_torch.io.png import read_png_rgb
    from craytpu_torch.models.wavefront_pt import WavefrontRenderer, render
    from craytpu_torch.ops import dense_isect as dx
    from craytpu_torch.ops import hitrec as hr
    from craytpu_torch.ops import traverse as trv
    from craytpu_torch.parallel.pool_shard import make_renderer
    from craytpu_torch.scene.compile import compile_scene
    from craytpu_torch.utils import golden

    t_phase = time.perf_counter()
    cs = compile_scene(load("stress_highpoly", {"width": W, "height": H,
                                                "samples": SPP}))
    # ---- K3's winners against K2's on the first 2^20-lane primary batch:
    # hit/miss identical, (inst, prim) equal on >= 0.999 of the lanes, K1
    # records bit-equal where they are
    o_b, d_b, lim_b = primary_batch(cs)
    T = o_b.shape[0]
    k2 = trv.closest_hit(cs.geom, o_b, d_b, lim_b, cs.tlas_end,
                         cs.stack_depth, cs.layout)
    k3 = dx.dense_hit(cs.geom, o_b, d_b, lim_b, cs.dense)
    ms_b = cuda_ms(lambda: dx.dense_hit(cs.geom, o_b, d_b, lim_b, cs.dense),
                   3)
    # ---- K3 against its plain version at the frame's batch sizes: every
    # lane of this 2^20-lane launch, and a 16,384-lane launch (the frame's
    # small batches) of its first lanes
    t0 = time.perf_counter()
    want = dx.dense_hit_plain(cs.geom, cs.dense, o_b, d_b, lim_b)
    for field in ("inst", "prim", "t"):
        bit_diff(getattr(k3, field), getattr(want, field),
                 f"K3 {field} on every lane of the primary batch")
    plain_s = time.perf_counter() - t0
    S = 16384
    small = dx.dense_hit(cs.geom, o_b[:S], d_b[:S], lim_b[:S], cs.dense)
    for field in ("inst", "prim", "t"):
        bit_diff(getattr(small, field), getattr(want, field)[:S],
                 f"K3 {field} at {S} lanes")
    # the cull's work and the u, v pairs, counted on every 16th block of
    # 256 lanes (whole blocks, so that the warps and blocks are the
    # kernel's) and scaled by 16
    sub = torch.nonzero((torch.arange(T, device=o_b.device) // 256) % 16
                        == 0)[:, 0]
    cull = dense_cull_counts(torch, cs.geom, cs.dense, o_b[sub], d_b[sub],
                             lim_b[sub])
    cull = {k: 16 * v for k, v in cull.items()}
    uv = cull["uv_all"]
    del want, small
    n_hm = int(((k2.inst >= 0) != (k3.inst >= 0)).sum())
    same = (k2.inst == k3.inst) & (k2.prim == k3.prim)
    frac = float(same.float().mean())
    recs = [hr.hitrec_record(cs.tri_wide, cs.inst_wide, o_b, d_b, h.t,
                             h.prim, h.inst, cs.sphere_uv) for h in (k2, k3)]
    bit_diff(recs[1][same], recs[0][same], "K1 records of K3's winners")
    full, _, pairs, _ = dense_bound(cs.dense, T, T, cull, False)
    bound, by, _, _ = dense_bound(cs.dense, T, T, cull, True)
    kernels["dense_hit"].update(ms_primary_batch=ms_b)
    print(f"dense: K3 on the 1080p primary batch B={T}: {ms_b:.3f} ms "
          f"({pairs:.3e} pairs, about {uv:.3e} of them need u and v; bound "
          f"of the culled search {bound:.3f} ms ({by}, "
          f"{100 * bound / ms_b:.1f}% of it), of the full search "
          f"{full:.2f} ms ({100 * full / ms_b:.1f}%)); bit-equal to the "
          f"plain version on every lane (plain {plain_s:.1f} s) and on a "
          f"{S}-lane launch; against K2: "
          f"{n_hm} hit/miss differences, (inst, prim) equal on {frac:.6f} "
          f"of the lanes ({T - int(same.sum())} differ), K1 records "
          f"bit-equal where equal; {int((k3.inst >= 0).sum())} hits",
          flush=True)
    print(f"dense: K3 cull on the primary batch (every 16th block, x16): "
          f"{fmt_cull(cull)}", flush=True)
    if n_hm or frac < 0.999:
        fail("dense: K3's winners against K2's on the primary batch")
    del o_b, d_b, lim_b, k2, k3, recs, same, sub
    # ---- K3 on rays that graze the planes of the frame's triangles
    cs_cpu = compile_scene(load("stress_highpoly", {"width": 32,
                                                    "height": 24}), "cpu")
    check_graze(torch, cs, *graze_batch(cs_cpu, 20263),
                "stress_highpoly (phase 12)")
    del cs_cpu

    walk = make_renderer(cs)                      # built before the switch
    prev = os.environ.get("CRAYTPU_TRAVERSAL")
    os.environ["CRAYTPU_TRAVERSAL"] = "dense"
    try:
        # ---- both stress goldens, per pass and persistent
        for name in ("stress_highpoly", "stress_instances"):
            cs_g = compile_scene(load(name, {"width": 80, "height": 50,
                                             "samples": 4}))
            for path, fn in (
                    ("per-pass", lambda: render(cs_g, spp=4)),
                    ("persistent",
                     lambda: make_renderer(cs_g).render_persistent(4))):
                fb, n2, n1, n3 = counted_all(fn)
                ok, within, mean_abs = golden.compare(fb, name, 80, 50, 4)
                print(f"dense golden {name} 80x50 4spp {path}: within1lsb="
                      f"{within:.5f} mean_abs={mean_abs:.4f} ok={ok}; "
                      f"launches K3 {n3}, K2 {n2}, K1 {n1}", flush=True)
                if not ok or n3 == 0 or n2 != 0:
                    fail(f"dense golden {name} {path}")

        # ---- the persistent 1080p frame: a 1-spp frame first picks the
        # largest spp of {4, 2, 1} whose frames fit DENSE_FRAMES_S
        ren = make_renderer(cs)
        if ren.traversal_mode != "dense":
            fail(f"dense: the renderer took {ren.traversal_mode}")
        t0 = time.perf_counter()
        ren.render_persistent(1, fetch=False)
        torch.cuda.synchronize()
        probe = time.perf_counter() - t0
        spp = next((s for s in (4, 2, 1)
                    if 3 * s * probe <= DENSE_FRAMES_S), 1)
        print(f"dense: a persistent 1080p frame at 1 spp {probe:.2f} s -> "
              f"frames at {spp} spp (of the scene's {SPP})", flush=True)
        # ---- the CLI under dense, as a user runs it
        cli_dir = os.path.join(REPO, "build", "chip_smoke", "dense_cli")
        os.makedirs(cli_dir, exist_ok=True)
        cmd = [sys.executable, "-m", "craytpu_torch",
               os.path.join(REPO, "assets", "stress_highpoly.json"), "-s",
               str(spp), "-d", f"{W}x{H}"]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, cwd=cli_dir, env=cli_env(),
                             capture_output=True, text=True, timeout=600)
        png = os.path.join(cli_dir, "output", "stress_highpoly_0000.png")
        if res.returncode != 0 or not os.path.exists(png):
            fail(f"dense CLI exited {res.returncode}: {res.stderr[-2000:]}")
        img = read_png_rgb(png)
        if img.shape != (H, W, 3) or not img.max() > 0:
            fail(f"dense CLI image: shape {img.shape}, max {img.max()}")
        print(f"dense CLI CRAYTPU_TRAVERSAL=dense {' '.join(cmd[2:])}: exit "
              f"0 in {time.perf_counter() - t0:.1f} s; wrote {img.shape}",
              flush=True)

        # ---- paths/s in turns: dense, walk, walk, dense, after a frame of
        # each at this spp (their graphs' captures); the first dense frame
        # counts the launches (set to 0 just before, read just after) and
        # its peak device memory
        for r in (ren, walk):
            r.render_persistent(spp, fetch=False)
        rates = {"dense": [], "walk": []}
        peak = {}
        for kind in ("dense", "walk", "walk", "dense"):
            r = ren if kind == "dense" else walk
            first = not rates[kind]
            if first:
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            fb, n2, n1, n3 = counted_all(lambda: r.render_persistent(
                spp, fetch=first and kind == "dense"))
            torch.cuda.synchronize()
            rates[kind].append(W * H * spp / (time.perf_counter() - t0))
            if first:
                peak[kind] = torch.cuda.max_memory_allocated()
            if first and kind == "dense":
                counts = (n3, n2, n1)
                if fb.shape != (H, W, 4) or not np.isfinite(fb).all() \
                        or not fb[..., :3].max() > 0.0:
                    fail(f"dense frame: shape {fb.shape}, finite="
                         f"{np.isfinite(fb).all()}")
        n3, n2, n1 = counts
        if n3 == 0 or n2 != 0 or n1 == 0:
            fail(f"dense frame launched K3 {n3}x, K2 {n2}x, K1 {n1}x")
        kernels["dense_hit"]["launches"] = n3
        print(f"dense persistent frame stress_highpoly {W}x{H} {spp}spp "
              f"bounces={ren.max_depth}: launches K3 {n3}, K1 {n1}, K2 {n2}; "
              f"peak device memory {peak['dense'] / 2**30:.3f} GiB (walk "
              f"{peak['walk'] / 2**30:.3f}); paths/s in turns "
              f"(dense, walk, walk, dense): {fmt_rates(rates)}; dense/walk "
              f"{np.median(rates['dense']) / np.median(rates['walk']):.4f}",
              flush=True)
        del ren
        kernels.setdefault("graphs", {})["dense"] = graph_vs_eager(
            torch, f"dense persistent 1080p {spp}spp",
            lambda g: make_renderer(cs, graphs=g), persistent_frame, spp,
            {"dense_hit": "dense_hit_kernel", "hitrec": "hitrec_kernel"},
            rounds=1)

        # ---- a diff_geometry fwd+bwd on tests/test_vertex_grad.py's cube
        cs_f = load_buf(FLAT_SCENE)
        yy, xx = np.mgrid[20:44, 30:60]
        fx = torch.tensor(xx.reshape(-1), dtype=torch.int32,
                          device=cs_f.device)
        fy = torch.tensor(yy.reshape(-1), dtype=torch.int32,
                          device=cs_f.device)
        grads = {}
        for mode in ("auto", "dense"):
            os.environ["CRAYTPU_TRAVERSAL"] = mode
            tr = WavefrontRenderer(cs_f, bounces=2).make_trace_fn(
                2, diff_geometry=True)
            p = leaf_params(cs_f.params)
            tp = cs_f.geom.tri_packed.clone().requires_grad_()
            (img_f, _), n2, n1, n3 = counted_all(
                lambda: fwd_bwd(torch, tr, p, tp, fx, fy, 0, 1))
            grads[mode] = dict(table_grads(torch, p), tri_packed=tp.grad,
                               image=img_f)
            if (n3 > 0) != (mode == "dense") or (n2 > 0) == (mode == "dense"):
                fail(f"dense grad ({mode}): K3 {n3}x, K2 {n2}x")
        worst, g_ok = 0.0, True
        for k, v in grads["auto"].items():
            ok, _, ratio = close(grads["dense"][k], v, 2e-4, 1e-6)
            g_ok &= ok
            worst = max(worst, ratio)
        g_max = float(grads["dense"]["tri_packed"].abs().max())
        print(f"dense grad: flat cube fwd+bwd with diff_geometry=True, image "
              f"and gradients (tri_packed max |g| {g_max:.3e}) against the "
              f"walk's: ok={g_ok} (worst |d|/tol {worst:.3f})", flush=True)
        if not g_ok or g_max == 0:
            fail("dense grad: gradients against the walk's")
    finally:
        if prev is None:
            os.environ.pop("CRAYTPU_TRAVERSAL", None)
        else:
            os.environ["CRAYTPU_TRAVERSAL"] = prev
    print(f"dense: phase {time.perf_counter() - t_phase:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# phase 13: the runtime switches

def fast_kernel_checks(torch) -> dict:
    """Each kernel's fast variant (this process runs under
    CRAYTPU_FASTMATH=1) against its fast plain version on the card, at
    phase 2's shapes and inputs: bit-equal, or fail. Returns each
    kernel's {"ms", "plain_ms", "max_abs_err"}."""
    from craytpu_torch.ops import cuda_build
    from craytpu_torch.ops import dense_isect as dx
    from craytpu_torch.ops import hitrec as hr
    from craytpu_torch.ops import traverse as trv
    from craytpu_torch.ops import vecmath as vm
    from craytpu_torch.scene.compile import compile_scene
    if not vm._FASTMATH:
        fail("fast kernel checks without CRAYTPU_FASTMATH=1")
    host = load("stress_highpoly", {"width": W, "height": H})
    cs_cpu = compile_scene(host, "cpu")
    cs_dev = compile_scene(host, "cuda")
    geom, layout = cs_dev.geom, cs_dev.layout
    rng = np.random.default_rng(20260)          # phase 2's inputs
    o, d, limit = [x.cuda() for x in mixed_rays(cs_cpu, rng, 1 << 16)]
    k1_in = [x.cuda() for x in winner_ids(cs_cpu, rng, 1 << 20)]
    out = {}

    def check(name, kernel, plain, fields):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        got = kernel()
        a.record()
        want = plain()
        b.record()
        torch.cuda.synchronize()
        if (name, True) not in cuda_build._LIBS:
            fail(f"{name}: the fast variant was not loaded")
        err = 0.0
        for f in fields:
            g = getattr(got, f) if f else got
            w = getattr(want, f) if f else want
            err = max(err, bit_diff(g, w, f"{name} fast {f or 'record'}"))
        out[name] = {"ms": cuda_ms(kernel, 5), "plain_ms": a.elapsed_time(b),
                     "max_abs_err": err}

    args = (cs_dev.tlas_end, cs_dev.stack_depth)
    check("closest_hit",
          lambda: trv.closest_hit(geom, o, d, limit, *args, layout),
          lambda: trv.traverse_plain(geom, o, d, limit, *args),
          ("inst", "prim", "t"))
    tw, iw = cs_dev.tri_wide, cs_dev.inst_wide
    check("hitrec", lambda: hr.hitrec_record(tw, iw, *k1_in, True),
          lambda: hr.hitrec_plain(tw, iw, *k1_in, True), ("",))
    check("dense_hit",
          lambda: dx.dense_hit(geom, o, d, limit, cs_dev.dense),
          lambda: dx.dense_hit_plain(geom, cs_dev.dense, o, d, limit),
          ("inst", "prim", "t"))
    # the fast K3 on phase 2's grazing rays, every lane
    import pathlib
    import tempfile
    check_graze(torch, cs_dev, *graze_batch(cs_cpu, 20261),
                "stress_highpoly (fast)")
    from tests.torch_dense_rays import floor_scene
    floor_cpu = floor_scene(pathlib.Path(tempfile.mkdtemp()))
    floor = floor_scene(pathlib.Path(tempfile.mkdtemp()), "cuda")
    check_graze(torch, floor, *graze_batch(floor_cpu, 20262, floor=True),
                "tilted floor (fast)")
    return out


def switch_child(checks: bool = False) -> None:
    """Phase 13's child process: a persistent 1080p frame of
    stress_highpoly under this process's CRAYTPU_FASTMATH (read when
    vecmath is imported), one warm-up and one timed. With `checks`, first
    fast_kernel_checks and both stress goldens at 80x50, 4 spp (printed,
    not gated: fast math is not golden-exact). Prints one line
    `switch child: {json}`."""
    import torch
    from craytpu_torch.models.wavefront_pt import render
    from craytpu_torch.ops import vecmath as vm
    from craytpu_torch.parallel.pool_shard import make_renderer
    from craytpu_torch.scene.compile import compile_scene
    from craytpu_torch.utils import golden
    from craytpu_torch.utils.torchsetup import setup_torch
    setup_torch()
    out = {"fastmath": vm._FASTMATH}
    if checks:
        out["kernels"] = fast_kernel_checks(torch)
        out["golden"] = {}
        for name in ("stress_highpoly", "stress_instances"):
            cs = compile_scene(load(name, {"width": 80, "height": 50,
                                           "samples": 4}))
            out["golden"][name] = golden.compare(render(cs, spp=4), name,
                                                 80, 50, 4)
    cs = compile_scene(load("stress_highpoly", {"width": W, "height": H,
                                                "samples": SPP}))
    ren = make_renderer(cs)
    frame_persistent(torch, ren)                     # warm-up
    out["paths_s"] = W * H * SPP / frame_persistent(torch, ren)
    print("switch child: " + json.dumps(out), flush=True)


def run_switch_child(fastmath: bool, checks: bool) -> dict:
    """switch_child in a new process with CRAYTPU_FASTMATH set or unset;
    fails if it does."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.pop("CRAYTPU_FASTMATH", None)
    if fastmath:
        env["CRAYTPU_FASTMATH"] = "1"
    res = subprocess.run(
        [sys.executable, "-c", "import chip_smoke as c; "
         f"c.switch_child(checks={checks})"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300)
    lines = [ln for ln in res.stdout.splitlines()
             if ln.startswith("switch child: ")]
    if res.returncode != 0 or not lines:
        fail(f"switch child (CRAYTPU_FASTMATH={int(fastmath)}) exited "
             f"{res.returncode}: {res.stdout[-2000:]} {res.stderr[-2000:]}")
    out = json.loads(lines[-1][len("switch child: "):])
    if out["fastmath"] != fastmath:
        fail(f"switch child: CRAYTPU_FASTMATH={int(fastmath)} not seen")
    return out


@contextlib.contextmanager
def plain_records():
    """Within the block the integrator's hit records come from
    hitrec_plain (the plain version, craytpu's XLA twin) on the card in
    place of K1: what K1 is worth end to end. Isect calls
    hitrec.hitrec_record by its module name, so the block swaps that
    name; the port itself has no route from the card to hitrec_plain."""
    from craytpu_torch.ops import hitrec as hr
    k1 = hr.hitrec_record
    hr.hitrec_record = hr.hitrec_plain
    try:
        yield
    finally:
        hr.hitrec_record = k1


def record_turns(torch, cs, order) -> dict:
    """Persistent frames of cs (fetch=False, one renderer) with the
    records from K1 ("kernel") or from the plain version ("plain"), in
    `order`. The first frame of each counts K1/K2 launches (counters set
    to 0 just before, read just after) and keeps its frame on the host.
    Returns {name: {"paths_s": [...], "frame", "k2", "k1"}}."""
    from craytpu_torch.parallel.pool_shard import make_renderer
    ren = make_renderer(cs)
    # warm-up of each record's graphs (swapping the record function
    # captures afresh)
    ren.render_persistent(SPP, fetch=False)
    with plain_records():
        ren.render_persistent(SPP, fetch=False)
    out = {}
    for name in order:
        def frame():
            plain = name == "plain"
            with plain_records() if plain else contextlib.nullcontext():
                t0 = time.perf_counter()
                fb = ren.render_persistent(SPP, fetch=False)
                torch.cuda.synchronize()
                return fb, time.perf_counter() - t0
        if name in out:
            out[name]["paths_s"].append(W * H * SPP / frame()[1])
            continue
        (fb, secs), n_k2, n_k1 = counted(torch, frame)
        out[name] = {"paths_s": [W * H * SPP / secs], "frame": fb.cpu(),
                     "k2": n_k2, "k1": n_k1}
    return out


def phase_switches(torch, kernels: dict) -> None:
    """Phase 13: the runtime switches, on persistent 1080p frames of
    stress_highpoly, each pair of settings in turns (A, B, B, A)."""
    from craytpu_torch.scene.compile import compile_scene
    t_phase = time.perf_counter()

    # ---- CRAYTPU_FASTMATH: read when vecmath is imported, so each frame
    # is a child process (exact, fast, fast, exact); the first fast one
    # also holds the fast kernels against their fast plain versions
    children = [run_switch_child(f, checks=(f and i == 1))
                for i, f in enumerate((False, True, True, False))]
    fk = children[1]["kernels"]
    from craytpu_torch.ops import cuda_build
    for name, k in fk.items():
        kn = kernels[name]
        kn["ms_fast"] = k["ms"]
        kn["plain_ms_fast"] = k["plain_ms"]
        # the fast variant's operations: the exact count scaled by the two
        # variants' static f32 SASS instructions (the work is the same,
        # each primitive cheaper); its bytes are the exact variant's
        f32 = [sum(u.get("f32", 0) for fn, u in cuda_build.kernel_usage(
            name, fast).items() if f"{name}_kernel" in fn)
            for fast in (False, True)]
        kn["bound_ms_fast"] = max(kn["bound_bytes_ms"],
                                  kn["bound_ops_ms"] * f32[1] / f32[0])
        print(f"switches fastmath: {name} fast variant bit-equal to its "
              f"fast plain version; {k['ms']:.4f} ms (exact variant, phase "
              f"2: {kn['ms']:.4f} ms; fast/exact "
              f"{k['ms'] / kn['ms']:.3f}), plain on card "
              f"{k['plain_ms']:.2f} ms; bound {kn['bound_ms_fast']:.4f} ms "
              f"(f32 SASS instructions fast/exact {f32[1]}/{f32[0]}; "
              f"{100 * kn['bound_ms_fast'] / k['ms']:.1f}% of it)",
              flush=True)
    for name, (ok, within, mean_abs) in children[1]["golden"].items():
        print(f"switches fastmath golden {name} 80x50 4spp (printed, not "
              f"gated): within1lsb={within:.5f} mean_abs={mean_abs:.4f} "
              f"ok={ok}", flush=True)
    ex = [children[0]["paths_s"], children[3]["paths_s"]]
    fa = [children[1]["paths_s"], children[2]["paths_s"]]
    print(f"switches fastmath: persistent frame paths/s exact "
          f"{ex[0]:.0f} {ex[1]:.0f}, fast {fa[0]:.0f} {fa[1]:.0f} (child "
          f"processes in turns: exact, fast, fast, exact); fast/exact "
          f"{np.mean(fa) / np.mean(ex):.3f}", flush=True)

    # ---- what K1 is worth: K1's records against the plain version's on
    # the card (CRAYTPU_HITREC=xla maps to K1 in the port; plain_records)
    cs = compile_scene(load("stress_highpoly", {"width": W, "height": H,
                                                "samples": SPP}))
    res = record_turns(torch, cs, ["kernel", "plain", "plain", "kernel"])
    if res["kernel"]["k1"] == 0 or res["plain"]["k1"] != 0:
        fail(f"switches record: K1 launches kernel {res['kernel']['k1']}, "
             f"plain {res['plain']['k1']}")
    ref = res["kernel"]["frame"]
    ok, err, _ = close(res["plain"]["frame"], ref, 2e-5, 2e-6)
    if not ok or not bool(torch.isfinite(ref).all()):
        fail(f"switches record: the plain record's frame differs from "
             f"K1's (max |d| {err:.3e})")
    mean = {name: float(np.mean(r["paths_s"])) for name, r in res.items()}
    print("switches record (persistent frames in turns): " + "; ".join(
        f"{name}: paths/s {' '.join(f'{x:.0f}' for x in r['paths_s'])} "
        f"(mean {mean[name]:.0f}); k2 {r['k2']}, k1 {r['k1']}"
        for name, r in res.items())
        + f"; plain/kernel {mean['plain'] / mean['kernel']:.3f}", flush=True)
    print(f"switches: phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)


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
    secs = cuda_build.build_all(variants=(False, True))
    print(f"build: {secs:.1f} s, exact and fast variants -> "
          f"{cuda_build.build_dir()}", flush=True)
    for line in cuda_build.usage_lines() + cuda_build.usage_lines(
            fast=True):
        print(f"  {line}", flush=True)
    t_main = time.perf_counter()
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
    phase_shard(torch, kernels)
    phase_dense(torch, kernels)
    phase_switches(torch, kernels)
    for label, g in kernels["graphs"].items():
        print(f"graphs summary {label} ({g['spp']} spp): paths/s graphs "
              f"{np.median(g['paths_s']['graphs']):.0f}, eager "
              f"{np.median(g['paths_s']['eager']):.0f} (x{g['ratio']:.3f}); "
              f"busy " + ", ".join(f"{k} {100 * d / w:.1f}%" for k, (d, w)
                                   in g["busy"].items())
              + f"; host ms a dispatch graphs {g['graphs']['host_ms']:.3f}, "
              f"eager {g['eager']['host_ms']:.3f}; replays a frame "
              f"{g['graphs']['replays']}, captures {g['captures_first']}; "
              f"peak GiB graphs {g['graphs']['peak'] / 2**30:.3f}, eager "
              f"{g['eager']['peak'] / 2**30:.3f}", flush=True)
    print(f"chip_smoke: {time.perf_counter() - t_main:.1f} s", flush=True)
    # the card again, so that the end of a long log names it
    print(card_line(), flush=True)
    print(json.dumps({"kernels": [kernels["closest_hit"], kernels["hitrec"],
                                  kernels["dense_hit"]]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
