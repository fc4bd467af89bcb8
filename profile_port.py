#!/usr/bin/env python3
"""The port's kernels timed alone on one GPU, each launch shape held to
the plain version first.

    python3 profile_port.py --fps                   # FPS per call and plan
    python3 profile_port.py --ball-query            # ball query per call and plan
    python3 profile_port.py --scatter               # scatter per call and plan
    python3 profile_port.py --scatter-calls PATH    # scatter calls, any tree
    python3 profile_port.py --ffps                  # feature FPS per call and plan
    python3 profile_port.py --bn-relu               # BN + ReLU per layer
    python3 profile_port.py --box-points            # the box point count
    python3 profile_port.py --span-cost             # the tracer's host cost

The program's spans on the benchmark cells' own traffic are read by
trace_cells.py (--workload <cell>), and the kernels of a cell by time and
its idle gaps by portbench/run.py --trace 1.

--fps times the FPS kernel (csrc/fps.cu) at each main-path FPS call (the 5
of a request, a train step and an eval batch, and one config-#4 scene),
on seeded clouds, at the plan that ops/cuda/fps.py chooses and then at
each cluster size that fits the card in each register tier: each launch
is first held equal to the plain version, then timed by CUDA events (ms
and us a round). Then B2 on the KITTI cell's scans (portbench's frozen
generator, 122880 raw points, cropped and padded as the fit pads them):
the pruned pass (fps_flat) and the unpruned kernel at the same plan, each
held to the plain version first; the device ms of the pruned kernel and
of its pre-pass (the Z-order keys, the sorts) by torch.profiler, us a
round, and the engaged share (warp-rounds that ran their pass over all
warp-rounds) from the kernel's counter. Last, how many B2 clusters of the
cell's plan the card runs at once (cudaOccupancyMaxActiveClusters,
ops/cuda/fps.py::flat_clusters, which sizes the KITTI fit's side streams)
and B2 (pre-pass and kernel) on 8 of the cell's scans by CUDA events: one
scan alone, the 8 one after another on one stream, and the 8 each on a
stream of its own, as fit_scene runs a batch; the overlapped picks held
to the serial ones.

--ball-query times the ball-query kernel (csrc/ball_query.cu) at each
main-path ball-query call, on the inputs recorded from one served request,
one config-#3 train step and one config-#4 eval batch (chip_smoke.py's
recorders): exact, then the three SA1 calls through the sorted tier (the
scan alone, on the Z-order permutations, and the whole call). Each call
runs at the plan that ops/cuda/ball_query.py chooses and then at every
other shape (warps a block x centers a warp x loads from global or
shared memory); each launch is first held equal to the plain version (the
glue + plain for the sorted tier), then timed by CUDA events. About 500
lines: redirect them to a file.

--scatter times the scatter kernel (csrc/scatter.cu) at each of the 9
scatter calls of one config-#3 train step, on their recorded inputs, and
on heavy collisions (all of U on 8 rows), at the plan that
ops/cuda/scatter.py chooses and then at variants of it: the warps a CTA
and the channel slices. Each launch is first held bitwise to np.add.at on
the host, then timed by CUDA events (host included); then plan()'s and
index_add_'s device time by kernel (torch.profiler), and each variant's
sum over the step.

--scatter-calls PATH times ops.scatter_rows, whichever scatter kernel the
package on the path has, at the 9 scatter calls of one train step saved
in PATH (recorded and saved there first where PATH does not exist): per
call and summed, its time with the host (CUDA events), the card's alone
(torch.profiler), and index_add_'s. Run from an unpacked older commit
(with this file copied there) on the same PATH, it compares two commits'
kernels on one card and one input.

--ffps times the feature-space FPS kernel (csrc/ffps.cu, 3DSSD's F-FPS)
at the two calls of one request of the 3DSSD cell (16 of the cell's scans
fitted by data/kitti.py::fit_scene, the cell's configuration with seeded
weights, BatchNorm calibrated on them as the cell's set-up does; the calls'
inputs recorded from the served program): each at the plan that
ops/cuda/ffps.py chooses (the first of its candidates that the card
places in one wave) and then at every cluster size 1-8, first held
equal to the plain version, then timed by CUDA events (ms, us a round),
beside its bound (portbench/counts/ssd3d.py) and the plain version's ms;
then the registers and spills of each kernel instance (nvcc's -Xptxas=-v
report, where this process built the library).

--bn-relu times the eval-mode BatchNorm + ReLU kernel (csrc/bn_relu.cu)
at each BatchNorm layer of one request of each serving cell (sweep B = 32,
latency B = 1, KITTI B = 8, 3DSSD B = 16: the shapes recorded from the
served program, chip_smoke.BN_RELU_SERVED's models), on seeded inputs of
those shapes: first bitwise the plain chain, then the kernel's and the
chain's ms by CUDA events beside the bound (the activation read and
written once, the four vectors read once, at 3.35 TB/s) and the kernel's
GB/s; each request's sums; then the kernel instances' registers and
spills (nvcc's -Xptxas=-v report, where this process built the library).

--box-points times the box point-count kernel (csrc/box_points.cu, the
Group-Free parse's non-empty filter) at the call of one request of the
eval-groupfree-scannet-b16 cell (16 of the cell's rooms, the cell's
configuration with seeded weights and BatchNorm calibrated on them as the
cell's set-up does; the call's points, mask, centres and sizes recorded
from the served program): the kernel's counts first held equal to the
plain version's, then its ms by CUDA events beside its bound
(portbench/counts/groupfree.py::box_points_cost: the operations' and the
bytes' bound, the larger one named) and the plain version's ms; then the
kernel's registers and spills (nvcc's -Xptxas=-v report, where this
process built the library).

--span-cost times the tracer itself (tpu3dsad_torch/utils/trace.py): the
host us of an empty span, off, on (a CUDA event pair), and on under a
running profiler (a range too); then the us of making and recording one
CUDA event, and of recording a made one again.
"""

from __future__ import annotations

import argparse
import shutil
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from chip_smoke import (
    BN_RELU_REQUEST,
    BQ_SHAPES,
    EVAL_B,
    EVAL_N,
    FPS_SHAPES,
    TRAIN_B,
    TRAIN_N,
    B,
    N,
    add_at,
    bits_differ,
    capture_eval_batch,
    capture_request,
    capture_train_step,
    cell_config,
    longest_row,
    phase_device,
    prepare_outdoor,
    require_equal,
    served_request,
)
from portbench.traffic import outdoor as outdoor_traffic
from tpu3dsad_torch import ops
from tpu3dsad_torch.data import kitti
from tpu3dsad_torch.ops import sorted as sorted_bq
from tpu3dsad_torch.ops.cuda import ball_query as cuda_bq
from tpu3dsad_torch.ops.cuda import build
from tpu3dsad_torch.ops.cuda import fps as cuda_fps
from tpu3dsad_torch.ops.cuda import scatter as cuda_scatter
from tpu3dsad_torch.ops.plain import ball_query as plain_bq
from tpu3dsad_torch.ops.plain import furthest_point_sample as plain_fps
from tpu3dsad_torch.utils import trace

# the bucketed crop of a config-#4 scene of 122880 raw points (4096s)
SCENE_N = 118784


def cuda_ms(fn, iters: int) -> float:
    """Mean ms per call over `iters` calls after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters




def fps_cases() -> list[tuple[str, str, int, int, int]]:
    """(path, call, B, N, M) of the FPS calls of one request, train step and
    eval batch, then one config-#4 scene's B2 call."""
    cases = [(path, name, b, n1 if name == "sa1" else n, m)
             for path, b, n1 in (("serve", B, N), ("train", TRAIN_B, TRAIN_N),
                                 ("eval4", EVAL_B, EVAL_N))
             for name, n, m in FPS_SHAPES]
    return cases + [("eval4", "scene", 1, SCENE_N, EVAL_N)]


def fps_shapes(b: int, n: int, sms: int) -> list:
    """Every launch shape worth timing for b clouds of n points: at each
    cluster size of 1, 2, 4, 8, 12, 16 that fits the card, each register
    tier with the fewest threads that cover n, or the memory tier where
    none does."""
    shapes = []
    for c in sorted({1, 2, 4, 8, 12, 16} & set(range(1, sms // b + 1)),
                    reverse=True):
        per_cta = -(-n // c)
        tiers = [cuda_fps.Plan(c, 32 * -(-per_cta // (32 * p)), p)
                 for p in cuda_fps.REGISTER_TIERS]
        tiers = [t for t in tiers
                 if t.threads <= cuda_fps.REGISTER_TIERS[t.points]]
        shapes += tiers or [cuda_fps.Plan(c, cuda_fps.MAX_THREADS, 0)]
    return shapes


def profile_fps(card: str) -> None:
    """Each main-path FPS call on seeded uniform clouds (the scene with a
    masked tail, as the loader pads it), launched as plan() chooses (the C
    entry may step down its candidates) and then forced to each shape of
    fps_shapes(): exact against the plain version, then ms and us a round
    by CUDA events."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    for path, name, b, n, m in fps_cases():
        xyz = torch.empty(b, n, 3, device="cuda").uniform_(-3.0, 3.0,
                                                           generator=gen)
        mask = None
        if name == "scene":
            mask = torch.ones(b, n, dtype=torch.bool, device="cuda")
            mask[:, n - 2000:] = False
        want = plain_fps(xyz, m, mask=mask)
        chosen = cuda_fps.plan(b, n, sms)
        print(f"{path} {name} [{b},{n}]->{m}: plan() {chosen[0]} "
              f"({len(chosen)} candidates)")
        for plans in [None] + [[s] for s in fps_shapes(b, n, sms)]:
            require_equal(f"fps {path} {name} {plans}",
                          cuda_fps.fps_batched(xyz, m, mask, plans), want)
            used = cuda_fps.last_plan
            ms = cuda_ms(lambda: cuda_fps.fps_batched(xyz, m, mask, plans), 5)
            print(f"  {str(used):40s} {ms:9.3f} ms "
                  f"{ms * 1e3 / (m - 1):7.3f} us/round  equal"
                  f"{'  <- plan(), as launched' if plans is None else ''}")
    profile_b2(sms)
    profile_b2_overlap(sms)
    print(f"on {card}")


def cell_cloud(seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One KITTI cell scan cropped and padded as the fit pads it: (cloud
    [1, P, 3], mask [1, P]) on the card."""
    scan = outdoor_traffic.outdoor_scene(np.random.default_rng(seed), 122880)
    crop = torch.from_numpy(np.ascontiguousarray(
        scan[kitti.range_crop(scan), :3])).cuda()
    n = crop.shape[0]
    cloud = crop.new_zeros(1, -(-n // 4096) * 4096, 3)
    cloud[0, :n] = crop
    return cloud, (torch.arange(cloud.shape[1], device="cuda") < n)[None]


def profile_b2(sms: int, seeds=(1, 2, 3)) -> None:
    """B2 on the KITTI cell's scans (module docstring): exact, then the
    pruned pass's kernel and pre-pass device ms, the unpruned kernel's,
    and the engaged share."""
    m = EVAL_N
    for seed in seeds:
        cloud, mask = cell_cloud(seed)
        n = int(mask.sum())
        first = cuda_fps.plan(1, cloud.shape[1], sms)[0]
        want = plain_fps(cloud, m, mask=mask)
        engaged = torch.zeros(1, dtype=torch.int64, device="cuda")
        require_equal(f"B2 pruned seed {seed}",
                      cuda_fps.fps_flat(cloud, m, mask, engaged=engaged), want)
        require_equal(f"B2 unpruned seed {seed}",
                      cuda_fps.fps_batched(cloud, m, mask, [first]), want)
        warp_rounds = (m - 1) * first.cluster * first.threads // 32
        pruned = device_ms(lambda: cuda_fps.fps_flat(cloud, m, mask), 5)
        kernel = sum(v for k, v in pruned.items() if "fps_cluster" in k)
        prepass = sum(pruned.values()) - kernel
        unpruned = sum(device_ms(lambda: cuda_fps.fps_batched(
            cloud, m, mask, [first]), 5).values())
        print(f"B2 scan seed {seed}: {n} cropped of 122880 -> "
              f"[1,{cloud.shape[1]}]->{m}, {first}: pruned kernel "
              f"{kernel:.3f} ms ({kernel * 1e3 / (m - 1):.3f} us/round), "
              f"pre-pass {prepass:.3f} ms, engaged "
              f"{100 * engaged.item() / warp_rounds:.2f}% of "
              f"{warp_rounds} warp-rounds; unpruned {unpruned:.3f} ms "
              f"({unpruned * 1e3 / (m - 1):.3f} us/round); equal")
        print("  pre-pass by kernel: " + ", ".join(
            f"{k} {v:.4f}" for k, v in pruned.items()
            if "fps_cluster" not in k))


def profile_b2_overlap(sms: int, scans: int = 8) -> None:
    """B2's clusters at once, and B2 on `scans` of the cell's scans alone,
    in series and each on its own stream (module docstring)."""
    m = EVAL_N
    clouds = [cell_cloud(seed) for seed in range(1, scans + 1)]
    cloud, mask = clouds[0]
    n = cloud.shape[1]
    k = cuda_fps.flat_clusters(n, "cuda")
    print(f"B2 {cuda_fps.plan(1, n, sms)[0]} at [1,{n}]: {k} clusters at "
          f"once (cudaOccupancyMaxActiveClusters) on {sms} SMs")
    streams = [torch.cuda.Stream() for _ in clouds]

    def serial():
        return [cuda_fps.fps_flat(c, m, v) for c, v in clouds]

    def overlapped():
        caller, out = torch.cuda.current_stream(), []
        for s, (c, v) in zip(streams, clouds):
            s.wait_stream(caller)
            with torch.cuda.stream(s):
                out.append(cuda_fps.fps_flat(c, m, v))
        for s in streams:
            caller.wait_stream(s)
        return out

    for i, (got, want) in enumerate(zip(overlapped(), serial())):
        require_equal(f"B2 overlapped scan {i}", got, want)
    alone = cuda_ms(lambda: cuda_fps.fps_flat(cloud, m, mask), 3)
    one_stream = cuda_ms(serial, 3)
    own_streams = cuda_ms(overlapped, 3)
    print(f"B2 with its pre-pass: one scan alone {alone:.3f} ms; {scans} "
          f"scans on one stream {one_stream:.3f} ms; on {scans} streams "
          f"{own_streams:.3f} ms ({one_stream / own_streams:.2f}x, "
          f"{own_streams / alone:.2f} scans' time alone); equal")


def bq_shapes() -> list:
    """Every launch shape of the scan: 4, 8 or 16 warps a block, each
    template instance (centers a warp, loads)."""
    return [cuda_bq.Plan(w, c, shared) for shared in (False, True)
            for c in cuda_bq.CENTERS for w in (4, 8, 16)]


def time_bq_shapes(label: str, want, run) -> None:
    """run(launch) at plan()'s shape (launch None) and at each of
    bq_shapes(): exactly `want`, then ms by CUDA events, one line each."""
    for launch in [None] + bq_shapes():
        got = run(launch)
        require_equal(f"{label} {launch} idx", got[0], want[0])
        require_equal(f"{label} {launch} cnt", got[1], want[1])
        used = cuda_bq.last_plan
        ms = cuda_ms(lambda: run(launch), 10)
        print(f"  {str(used):40s} {ms:9.3f} ms  equal"
              f"{'  <- plan()' if launch is None else ''}")


def profile_ball_query(card: str, work: Path) -> None:
    """Each main-path ball-query call on its recorded inputs, exact, at
    every shape of the scan; then the three SA1 calls through the sorted
    tier: the codes and sorts, the scan at every shape, the whole call."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    shutil.rmtree(work, ignore_errors=True)
    recorded = {"serve": capture_request(),
                "train": capture_train_step(gen),
                "eval4": capture_eval_batch(prepare_outdoor(work))[1]}
    names = [name for name, *_ in BQ_SHAPES]
    for path, calls in recorded.items():
        for name, (args, kw) in zip(names, calls["ball_query"]):
            xyz, centers, r, k = args
            mask = kw.get("mask")
            (b, n), m = xyz.shape[:2], centers.shape[1]
            print(f"{path} {name} [{b},{n}] M={m} r={r:g} K={k}: plan() "
                  f"{cuda_bq.plan(b, n, m, k, sms)}")
            time_bq_shapes(f"ball_query {path} {name}",
                           plain_bq(xyz, centers, r, k, mask=mask),
                           lambda launch: cuda_bq.ball_query(
                               xyz, centers, r, k, mask, launch=launch))
    for path, calls in recorded.items():
        (xyz, centers, r, k), kw = calls["ball_query"][0]
        mask = kw.get("mask")
        with ops.use_impl("plain"):
            want = sorted_bq.sorted_ball_query(xyz, centers, r, k, mask=mask)
        perm, perm_c = sorted_bq.z_order(xyz, centers, mask)
        whole = cuda_ms(lambda: sorted_bq.sorted_ball_query(
            xyz, centers, r, k, mask=mask), 10)
        keys = cuda_ms(lambda: sorted_bq.z_order(xyz, centers, mask), 10)
        codes = cuda_ms(lambda: cuda_bq.morton_codes(xyz, centers, mask), 10)
        print(f"{path} sa1 sorted [{xyz.shape[0]},{xyz.shape[1]}]: whole "
              f"call {whole:.3f} ms; codes + sorts {keys:.3f} ms (codes "
              f"{codes:.3f}); the scan with map-back:")
        time_bq_shapes(f"sorted {path} sa1", want,
                       lambda launch: cuda_bq.ball_query(
                           xyz, centers, r, k, mask, perm=perm,
                           perm_c=perm_c, launch=launch))
    shutil.rmtree(work, ignore_errors=True)
    print(f"on {card}")


def scatter_variants(p, c: int) -> dict:
    """{label: plan}: plan() itself, then shapes that change one choice:
    the warps a CTA, and for wide rows the channel slices."""
    variants = {"plan()": p}
    for w in (4, 8, 16, 32):
        if w != p.warps:
            variants[f"warps {w}"] = p._replace(warps=w)
    for sl in (2, 3):
        if c > 64 * sl and sl != p.slices:
            variants[f"slices {sl}"] = p._replace(slices=sl)
    return variants


def device_ms(fn, calls: int = 10) -> dict:
    """{kernel name: device ms a call} of fn() by torch.profiler: the
    card's time without the host's."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    times = {}
    for e in prof.key_averages():
        if e.device_time_total > 0:
            name = e.key.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("<")[0].split()[-1]
            ms = e.device_time_total / calls / 1e3
            times[name] = times.get(name, 0.0) + ms
    return times


def index_add(g, idx, n):
    """The library call that computes the scatter: index_add_ into
    zeros."""
    b, u, c = g.shape
    flat = (idx.long() + torch.arange(b, device=g.device)[:, None] * n
            ).flatten()
    rows = g.reshape(b * u, c)
    return lambda: torch.zeros(b * n, c, device=g.device).index_add_(
        0, flat, rows)


def cta_skew(idx, n: int, span: int) -> str:
    """The entries of a CTA's rows, span rows a CTA: their mean, and the
    most of one CTA where it takes span rows in sequence and where it is
    dealt them round robin (K = the least power of two >= n / span CTAs a
    cloud), as the kernel deals them."""
    b = idx.shape[0]
    ok = (idx >= 0) & (idx < n)
    flat = (idx.long() + torch.arange(b, device=idx.device)[:, None] * n)[ok]
    per_row = torch.bincount(flat, minlength=b * n).view(b, n)
    ctas = 1
    while span * ctas < n:
        ctas *= 2
    seq = torch.nn.functional.pad(per_row, (0, -n % span)).view(b, -1, span)
    dealt = torch.nn.functional.pad(per_row, (0, -n % ctas)).view(b, -1, ctas)
    mean = per_row.sum().item() / (b * ctas)
    most_seq = seq.sum(-1).max().item()
    most_dealt = dealt.sum(1).max().item()
    return (f"entries a CTA: mean {mean:.0f}; the most, rows in sequence "
            f"{most_seq} ({most_seq / mean:.1f}x), dealt round robin "
            f"{most_dealt} ({most_dealt / mean:.1f}x)")


def profile_scatter(card: str) -> None:
    """Each scatter call of one train step on its recorded inputs at
    plan() and each variant: bitwise np.add.at, then timed; plan()'s and
    index_add_'s device time. Then SA2's shape with other indices: all of
    U on 8 rows, uniform over the rows, each row's entries adjacent in u
    (g read in order), and SA2's own indices with one channel (the scan
    of idx and the lists without the bytes of g)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    calls = [("step call", *args)
             for args, _ in capture_train_step(gen)["scatter"]]
    sa2_idx = calls[-1][2]
    b, u, n = TRAIN_B, 32768, 2048

    def normal(c):
        return 8.0 * torch.randn(b, u, c, device="cuda", generator=gen)

    for what, idx in (
            ("all of U on 8 rows",
             torch.randint(0, 8, (b, u), device="cuda", generator=gen)),
            ("uniform", torch.randint(0, n, (b, u), device="cuda",
                                      generator=gen)),
            ("each row's entries adjacent",
             (torch.arange(u, device="cuda") * n // u).expand(b, u))):
        calls.append((what, normal(131), idx.int().contiguous(), n))
    calls.append(("SA2's indices, one channel", normal(1), sa2_idx, n))

    per_call = []  # {label: ms} of each step call
    for i, (what, g, idx, n) in enumerate(calls):
        b, u, c = g.shape
        p = cuda_scatter.plan(b, u, n, c, sms)
        want = add_at(g, idx, n)
        print(f"scatter [{b},{u},{c}] -> n={n}, {what}: longest row "
              f"{longest_row(idx, n)}; plan() {p}")
        print("  " + cta_skew(idx, n, cuda_scatter.ROWS * p.warps))
        times = {}
        for label, launch in scatter_variants(p, c).items():
            got = cuda_scatter.scatter_rows(g, idx, n, launch)
            if (at := bits_differ(got.cpu(), want)) is not None:
                raise AssertionError(f"{label}: != np.add.at {at}")
            ms = cuda_ms(lambda: cuda_scatter.scatter_rows(g, idx, n, launch),
                         10)
            times[label] = ms
            print(f"  {label:10s} {str(launch):28s} {ms:8.3f} ms  "
                  f"bitwise np.add.at")
        ok = ((idx >= 0) & (idx < n)).flatten()
        key = torch.where(ok, (idx.long() + torch.arange(
            b, device="cuda")[:, None] * n).flatten(), b * n)
        order = torch.argsort(key, stable=True)[:int(ok.sum())]
        rows = g.reshape(b * u, c)
        for label, fn in (
                ("plan()", lambda: cuda_scatter.scatter_rows(g, idx, n)),
                ("index_add_", index_add(g, idx, n)),
                ("index_select of g's rows in row order",
                 lambda: rows.index_select(0, order)),
                ("g.clone()", g.clone)):
            print(f"  {label}, device ms a call by kernel: " + ", ".join(
                f"{k} {v:.4f}" for k, v in device_ms(fn).items()))
        ctas = build.library().tpu3dsad_scatter_occupancy(p.warps, p.slices,
                                                          c)
        print(f"  CTAs an SM at plan(): {ctas}")
        if i < 9:
            per_call.append(times)
    print("summed over the step's 9 calls (a variant that does not apply to "
          "a call counts its plan()):")
    labels = {k for times in per_call for k in times}
    sums = {k: sum(t.get(k, t["plan()"]) for t in per_call) for k in labels}
    for label, ms in sorted(sums.items(), key=lambda kv: kv[1]):
        print(f"  {label:10s} {ms:8.3f} ms")
    print(f"on {card}")


def profile_scatter_calls(card: str, path: Path) -> None:
    """ops.scatter_rows, whichever kernel this package has, at the 9
    scatter calls of one train step saved in `path` (recorded and saved
    first where it does not exist): per call and summed, its time with the
    host (CUDA events), the card's alone (torch.profiler), and
    index_add_'s."""
    if path.exists():
        calls = [(g.cuda(), idx.cuda(), n) for g, idx, n in torch.load(path)]
    else:
        gen = torch.Generator(device="cuda").manual_seed(0)
        calls = [args for args, _ in capture_train_step(gen)["scatter"]]
        path.parent.mkdir(parents=True, exist_ok=True)
        torch.save([(g.cpu(), idx.cpu(), n) for g, idx, n in calls], path)
    keys = ("ms", "device ms", "index_add_ ms", "index_add_ device ms")
    total = dict.fromkeys(keys, 0.0)
    for g, idx, n in calls:
        b, u, c = g.shape
        run, lib = (lambda: ops.scatter_rows(g, idx, n)), index_add(g, idx, n)
        got = dict(zip(keys, (cuda_ms(run, 20), sum(device_ms(run).values()),
                              cuda_ms(lib, 20), sum(device_ms(lib).values()))))
        for k in keys:
            total[k] += got[k]
        print(f"  [{b},{u},{c}] n={n}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in got.items()))
    print("  summed over the 9 calls: " + ", ".join(
        f"{k} {v:.4f}" for k, v in total.items()))
    print(f"on {card}")


def profile_span_cost(card: str, spans: int = 20000) -> None:
    """The tracer's host us a span, by part (module docstring)."""

    def us_a_span(n: int = spans) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            with trace.span("a"):
                pass
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e6

    def us_a_record(make: bool) -> float:
        event = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(spans):
            if make:
                event = torch.cuda.Event(enable_timing=True, external=True)
            event.record()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / spans * 1e6

    torch.zeros(1, device="cuda")
    rows = [("off", us_a_span())]
    trace.enable()
    rows.append(("on (a CUDA event pair)", us_a_span()))
    trace.collect()
    with profile(activities=[ProfilerActivity.CPU]):
        # a tenth as many: the profiler keeps every range
        rows.append(("on under torch.profiler (a range too)",
                     us_a_span(spans // 10)))
    trace.collect()
    trace.enable(False)
    rows += [("an event made and recorded", us_a_record(True)),
             ("a made event recorded again", us_a_record(False))]
    print(f"host us, the mean over {spans} calls:")
    for what, us in rows:
        print(f"  {what:40s} {us:9.3f}")
    print(f"on {card}")


def ffps_calls_of_a_request(seed: int = 2424000101) -> list:
    """(points [B, N, D], npoint, mask) of each feature-FPS call of one
    request of the 3DSSD cell, recorded from the served program."""
    import json

    from portbench import weights
    from portbench.harness import Context
    from tpu3dsad_torch import serving, train_lib
    from tpu3dsad_torch.models.ssd3d import SSD3D
    from tpu3dsad_torch.ops import library

    root = Path(__file__).resolve().parent
    config = json.loads((root / "portbench" / "configs"
                         / "3dssd-kitti-car-16k.json").read_text())
    w = json.loads((root / "portbench" / "workloads"
                    / "eval-3dssd-kitti-b16.json").read_text())
    cfg = Context.port_config(SimpleNamespace(config=config))
    train_lib.apply_runtime_config(cfg)
    model = SSD3D(cfg.model, device="cuda")
    state = {n: tuple(v.shape) for n, v in model.state_dict().items()}
    model.load_state_dict(weights.draw(state, seed, "cuda"))
    scans, _ = outdoor_traffic.scan_pool(
        np.random.default_rng(seed), dict(w, pool_batches=1,
                                          check_batches=1))
    raw = torch.from_numpy(scans[0]).cuda()
    B, N = w["batch"], w["budget"]
    rows = raw.new_zeros(B, N, 4)
    mask = torch.zeros(B, N, dtype=torch.bool, device="cuda")
    for b in range(B):
        fit = kitti.fit_scene(raw[b], N, "cuda")
        rows[b, :fit.rows.shape[0]] = raw[b, fit.rows]
        mask[b] = fit.mask
    points, feats = rows[..., :3].contiguous(), rows[..., 3:].contiguous()
    with torch.no_grad():
        model.train()
        model(points, feats, mask=mask, bn_momentum=0.0)
        model.eval()
    infer = serving.build_inference_fn(cfg, model, model.mean_sizes,
                                       with_features=True)
    calls, sound = [], library.ffps

    def record(p, m, k=None):
        calls.append((p.clone(), m, None if k is None else k.clone()))
        return sound(p, m, k)

    library.ffps = record
    try:
        infer(points, mask, feats)
    finally:
        library.ffps = sound
    return calls


def profile_ffps(card: str) -> None:
    """Each feature-FPS call of a 3DSSD request at plan() and at every other
    cluster size: exact against the plain version, then ms and us a round
    by CUDA events; its bound and the plain version's ms; the kernel
    instances' registers and spills."""
    from portbench.counts.ssd3d import ffps_cost
    from portbench.counts import bound_seconds
    from tpu3dsad_torch.ops.cuda import ffps as cuda_ffps
    from tpu3dsad_torch.ops.plain import feature_fps as plain_ffps

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for i, (points, m, mask) in enumerate(ffps_calls_of_a_request()):
        b, n, d = points.shape
        want = plain_ffps(points, m, mask)
        plain_ms = cuda_ms(lambda: plain_ffps(points, m, mask), 1)
        bound = 1e3 * bound_seconds([ffps_cost(
            {"B": b, "n": n, "d": d, "m": m})])
        require_equal(f"ffps call {i} plan()",
                      cuda_ffps.feature_fps(points, m, mask), want)
        chosen = cuda_ffps.last_plan
        print(f"ffps call {i} [{b},{n},{d}]->{m}: bound {bound:.4f} ms, "
              f"plain {plain_ms:.3f} ms, plan() "
              f"{len(cuda_ffps.plan(b, n, d, sms))} candidates, launched "
              f"{chosen}")
        for c in range(1, min(cuda_ffps.MAX_CLUSTER, n) + 1):
            launch = cuda_ffps.plan_at(n, d, c)
            if launch is None:
                continue
            try:
                got = cuda_ffps.feature_fps(points, m, mask, plans=[launch])
            except RuntimeError as err:  # a size the card cannot place
                print(f"  {str(launch):58s} not launched: {err}")
                continue
            require_equal(f"ffps call {i} {launch}", got, want)
            ms = cuda_ms(lambda: cuda_ffps.feature_fps(points, m, mask,
                                                       plans=[launch]), 5)
            print(f"  {str(launch):58s} {ms:9.4f} ms "
                  f"{ms * 1e3 / (m - 1):7.3f} us/round  "
                  f"{100 * bound / ms:6.2f}% of bound  equal"
                  f"{'  <- plan(), as launched' if launch == chosen else ''}")
    report = [ln for ln in build.ptxas_log.splitlines()
              if "ffps_kernel" in ln or "registers" in ln or "spill" in ln]
    entry = None
    for ln in report:
        if "ffps_kernel" in ln:
            entry = ln.split("ffps_kernelI", 1)[1].split("EEEv", 1)[0]
        elif entry is not None and ("registers" in ln or "spill" in ln):
            print(f"  ffps_kernel<{entry}>: {ln.strip()}")
            if "registers" in ln:
                entry = None
    if not build.ptxas_log:
        print("  (the library was cached: no -Xptxas=-v report here)")
    print(f"on {card}")


# (cell, benchmark configuration, scenes a request) timed by --bn-relu
BN_RELU_CELLS = [("sweep", "sadet-sunrgbd-20k", 32),
                 ("latency", "sadet-sunrgbd-20k", 1),
                 ("kitti", "sadet-kitti-16k", 8),
                 ("3dssd", "3dssd-kitti-car-16k", 16)]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM


def bn_relu_layers(name: str, b: int) -> list:
    """(x shape, eps) of each BatchNorm layer of one served request."""
    from tpu3dsad_torch import train_lib
    from tpu3dsad_torch.ops import library

    cfg = cell_config(name)
    train_lib.apply_runtime_config(cfg)
    infer, args = served_request(cfg, b, seed=25)
    layers, sound = [], library.bn_relu

    def record(x, *rest):
        layers.append((tuple(x.shape), rest[-1]))
        return sound(x, *rest)

    library.bn_relu = record
    try:
        infer(*args)
    finally:
        library.bn_relu = sound
    return layers


def profile_bn_relu(card: str) -> None:
    """Each BatchNorm layer of a request of each serving cell: the kernel
    bitwise the chain, then both timed, beside the bound."""
    from tpu3dsad_torch.ops.cuda import bn_relu as cuda_bn_relu
    from tpu3dsad_torch.ops.plain import bn_relu as plain_bn_relu

    for cell, name, b in BN_RELU_CELLS:
        layers = bn_relu_layers(name, b)
        arch = "ssd3d" if name.startswith("3dssd") else "sadet"
        if len(layers) != BN_RELU_REQUEST[arch]:
            raise AssertionError(f"{cell}: {len(layers)} BatchNorm layers")
        print(f"{cell} ({name}, B = {b}): {len(layers)} layers")
        total = {"kernel": 0.0, "chain": 0.0, "bound": 0.0}
        gen = torch.Generator(device="cuda").manual_seed(25)
        for i, (shape, eps) in enumerate(layers):
            c = shape[-1]
            x = torch.randn(shape, device="cuda", generator=gen)
            vecs = [torch.randn(c, device="cuda", generator=gen)
                    for _ in range(4)]
            vecs[1] = vecs[1].abs()
            where = bits_differ(cuda_bn_relu.bn_relu(x, *vecs, eps),
                                plain_bn_relu(x, *vecs, eps))
            if where:
                raise AssertionError(f"{cell} layer {i} {shape}: {where}")
            iters = max(3, min(50, int(2e9 // max(x.numel(), 1))))
            k_ms = cuda_ms(lambda: cuda_bn_relu.bn_relu(x, *vecs, eps),
                           iters)
            c_ms = cuda_ms(lambda: plain_bn_relu(x, *vecs, eps), iters)
            nbytes = 8 * x.numel() + 16 * c
            bound = 1e3 * nbytes / HBM_BYTES_PER_S
            for k, v in (("kernel", k_ms), ("chain", c_ms),
                         ("bound", bound)):
                total[k] += v
            print(f"  layer {i:2d} {str(list(shape)):22s} kernel "
                  f"{k_ms:8.4f} ms ({nbytes / k_ms / 1e6:7.1f} GB/s, "
                  f"{100 * bound / k_ms:5.1f}% of bound {bound:.4f}) "
                  f"chain {c_ms:8.4f} ms  bitwise")
            del x, vecs
        print(f"  {cell} request: kernel {total['kernel']:.3f} ms, chain "
              f"{total['chain']:.3f} ms, bound {total['bound']:.3f} ms "
              f"({100 * total['bound'] / total['kernel']:.1f}% of it)")
        torch.cuda.empty_cache()
    report = [ln.strip() for ln in build.ptxas_log.splitlines()
              if "bn_relu_kernel" in ln or "registers" in ln
              or "spill" in ln]
    entry = None
    for ln in report:
        if "bn_relu_kernel" in ln:
            entry = ln.split("bn_relu_kernelILi", 1)[1].split("E", 1)[0]
        elif entry is not None:
            print(f"  bn_relu_kernel<{entry}>: {ln}")
            if "registers" in ln:
                entry = None
    if not build.ptxas_log:
        print("  (the library was cached: no -Xptxas=-v report here)")
    print(f"on {card}")


def box_points_call(seed: int = 2426000101) -> tuple:
    """(points, centers, sizes, mask) of the point count of one request of
    the Group-Free cell, as its driver builds and serves it."""
    from portbench import weights
    from portbench.traffic.detection import class_mean_sizes
    from portbench.traffic.indoor import sweep_pool
    from tpu3dsad_torch import serving, train_lib
    from tpu3dsad_torch.models.groupfree import GroupFree3D
    from tpu3dsad_torch.ops import library

    cfg = cell_config("groupfree3d-scannet-l12o256")
    train_lib.apply_runtime_config(cfg)
    model = GroupFree3D(cfg.model, class_mean_sizes(cfg.model.num_classes))
    state = {n: tuple(v.shape) for n, v in model.state_dict().items()
             if v.is_floating_point()}
    model.load_state_dict(weights.draw(state, seed, "cuda"))
    w = {"pool_batches": 2, "batch": 16, "points": 50000, "budget": 51200,
         "check_batches": 1}
    pts, masks, _ = sweep_pool(np.random.default_rng(seed), w)
    batches = [(torch.from_numpy(pts[i]).cuda(),
                torch.from_numpy(masks[i]).cuda()) for i in range(2)]
    with torch.no_grad():
        model.train()
        model(batches[0][0], mask=batches[0][1], bn_momentum=0.0)
        model.eval()
    infer = serving.build_inference_fn(cfg, model, model.mean_sizes)
    calls, sound = [], library.box_points

    def record(points, centers, sizes, mask=None):
        calls.append((points, centers, sizes, mask))
        return sound(points, centers, sizes, mask)

    library.box_points = record
    try:
        infer(*batches[1])
    finally:
        library.box_points = sound
    if len(calls) != 1:
        raise AssertionError(f"{len(calls)} point counts in a request")
    return calls[0]


def profile_box_points(card: str) -> None:
    """The point count of a request of the Group-Free cell: the kernel
    equal to the plain version, then both timed, beside the bound."""
    from portbench.counts import PEAK_BYTES, PEAK_FLOPS
    from portbench.counts.groupfree import box_points_cost
    from tpu3dsad_torch.ops.cuda import box_points as cuda_box_points
    from tpu3dsad_torch.ops.plain import box_points as plain_box_points

    points, centers, sizes, mask = box_points_call()
    B, N = points.shape[:2]
    P = centers.shape[1]
    got = cuda_box_points.box_points(points, centers, sizes, mask)
    require_equal("box_points", got, plain_box_points(points, centers,
                                                      sizes, mask))
    ops_, nbytes = box_points_cost({"B": B, "n": N, "p": P})
    bounds = {"operations": 1e3 * ops_ / PEAK_FLOPS["fp32"],
              "bytes": 1e3 * nbytes / PEAK_BYTES}
    which = max(bounds, key=bounds.get)
    k_ms = cuda_ms(lambda: cuda_box_points.box_points(points, centers,
                                                      sizes, mask), 50)
    p_ms = cuda_ms(lambda: plain_box_points(points, centers, sizes, mask),
                   3)
    print(f"box_points [{B},{N}] x {P} boxes ({int(got.sum())} points in "
          f"boxes, {int((got > 5).sum())} boxes over 5): kernel "
          f"{k_ms:.4f} ms, {100 * bounds[which] / k_ms:.1f}% of its bound "
          f"{bounds[which]:.4f} ms (by its {which}; operations "
          f"{bounds['operations']:.4f}, bytes {bounds['bytes']:.4f}); plain "
          f"{p_ms:.3f} ms; equal")
    log = build.ptxas_log.splitlines()
    for i, ln in enumerate(log):
        if "box_points_kernel" in ln:
            for line in log[i + 1:i + 4]:
                if "registers" in line or "spill" in line:
                    print(f"  box_points_kernel: {line.strip()}")
    if not build.ptxas_log:
        print("  (the library was cached: no -Xptxas=-v report here)")
    print(f"on {card}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--fps", action="store_true",
                      help="time the FPS kernel per main-path call and "
                           "cluster size")
    mode.add_argument("--ball-query", action="store_true",
                      help="time the ball-query kernel per main-path call "
                           "and launch shape")
    mode.add_argument("--scatter", action="store_true",
                      help="time the scatter kernel per train-step call "
                           "and launch shape")
    mode.add_argument("--scatter-calls", type=Path, default=None,
                      metavar="PATH",
                      help="time ops.scatter_rows at the train step's "
                           "scatter calls saved in PATH (saved first if "
                           "absent)")
    mode.add_argument("--span-cost", action="store_true",
                      help="time the tracer's spans")
    mode.add_argument("--ffps", action="store_true",
                      help="time the feature-FPS kernel per 3DSSD call and "
                           "cluster size")
    mode.add_argument("--bn-relu", action="store_true",
                      help="time the BatchNorm + ReLU kernel per layer of "
                           "each serving cell's request")
    mode.add_argument("--box-points", action="store_true",
                      help="time the box point-count kernel at the "
                           "Group-Free cell's call")
    args = ap.parse_args()
    card = phase_device()
    if args.fps:
        profile_fps(card)
    elif args.ball_query:
        profile_ball_query(card, Path("build/profile/outdoor"))
    elif args.scatter:
        profile_scatter(card)
    elif args.scatter_calls:
        profile_scatter_calls(card, args.scatter_calls)
    elif args.ffps:
        profile_ffps(card)
    elif args.bn_relu:
        profile_bn_relu(card)
    elif args.box_points:
        profile_box_points(card)
    else:
        profile_span_cost(card)


if __name__ == "__main__":
    main()
