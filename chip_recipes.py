#!/usr/bin/env python3
"""Train the PyTorch / CUDA port on one GPU at the full length of three
committed reference recipes, and hold its learning curves to the
reference's (docs/experiments/).

    python3 chip_recipes.py R1 [--seed S]   # host18: 3200 steps
    python3 chip_recipes.py R2              # packed18: 12800 steps
    python3 chip_recipes.py R3 [--leg L]    # outdoor: 12000 steps, 3 legs
    [--work DIR] [--log-dir DIR]

Each recipe writes its data with the port's own writers (R2, R3), then
runs each leg as a process of the train entry, `python -m
tpu3dsad_torch.train ARGV`, resuming from train.ckpt_dir where a leg
follows another, as the reference's auto-resumes did. The entry's stdout
(the reference's JSONL record format) is written to
<log-dir>/<name>.jsonl (default docs/torch_experiments; a second seed
writes <name>_seed<S>.jsonl), its eval lines echoed here. Then
compare_curves holds the port's evals to the reference log's at the
reference's eval epochs, prints the comparison and records it, with the
card's name and power limit and each leg's wall seconds, under the log's
name in <log-dir>/summary.json. Data and checkpoints go under --work
(default build/recipes, which git ignores). `--leg L` runs leg L alone:
from scratch for leg 1, else resuming from leg L-1's last checkpoint
under --work.

The bars: the port's mean mAP over the reference's evals in the last
quarter of the run (epochs >= 75% of it) must reach the reference's mean
there less the recipe's band. The best mAP@0.25, AR@0.25, val_loss and
the mean train/loss over the last 10% of logged steps are printed beside
the reference's, without a bar.

The script runs on the card and exits nonzero where torch.cuda finds no
device. It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
REFERENCE_DIR = ROOT / "docs" / "experiments"
LOG_DIR = ROOT / "docs" / "torch_experiments"
WORK_DIR = ROOT / "build" / "recipes"
# the train entry a leg runs, as a user runs it
TRAIN = [sys.executable, "-m", "tpu3dsad_torch.train"]

# the 18-class model and schedule of docs/experiments/README.md's last
# line (r3_18cls_votefactor3 ran it at the default data.vote_candidates=3)
MODEL18 = ("data.num_points=8192", "data.max_boxes=16",
           "model.num_classes=18", "model.sa_npoints=(1024,512,256,128)",
           "model.sa_nsamples=(32,16,8,8)", "model.num_proposals=128",
           "train.batch_size=8", "train.num_epochs=400",
           "train.eval_every=50", "train.lr=0.002",
           "train.lr_decay_steps=(200,300)", "train.lr_decay_rates=(0.3,0.3)")


@dataclass(frozen=True)
class Recipe:
    """One reference run: its log under docs/experiments, the data it
    needs ("" for the host's synthetic scenes, "packed" for the
    ScanNet-format scenes packed, "outdoor" for the KITTI-format scenes),
    the train entry's argv of each leg (data.root and train.ckpt_dir are
    added), its epoch length in steps, and the band of each barred metric
    below the reference's last-quarter mean."""

    name: str
    reference: str
    data: str
    legs: tuple[tuple[str, ...], ...]
    steps_per_epoch: int
    bands: tuple[tuple[str, float], ...]

    def epochs(self, leg: int) -> int:
        """train.num_epochs of leg `leg` (0-based)."""
        return int(_value(self.legs[leg], "train.num_epochs"))

    @property
    def steps(self) -> int:
        return self.epochs(len(self.legs) - 1) * self.steps_per_epoch

    @property
    def k(self) -> int:
        """train.steps_per_call (1 where the argv leaves the default)."""
        try:
            return int(_value(self.legs[0], "train.steps_per_call"))
        except KeyError:
            return 1


def _value(argv, key: str) -> str:
    """The last value that argv gives `key`."""
    values = [a.split("=", 1)[1] for a in argv if a.startswith(key + "=")]
    if not values:
        raise KeyError(key)
    return values[-1]


RECIPES = {
    # r3_18cls_votefactor3: host synthetic scenes, fresh every step; the
    # log has a train line every 80 steps
    "R1": Recipe(
        "host18", "r3_18cls_votefactor3.jsonl", "",
        (("data.name=synthetic", *MODEL18, "train.log_every=80"),),
        steps_per_epoch=8,
        bands=(("mAP@0.25", 0.05), ("mAP@0.5", 0.05))),
    # r3_18cls_packed_pipeline, leg 1: 256 + 64 ScanNet-format scenes,
    # packed at 8192 points, augmented on the card, 8 steps a call
    "R2": Recipe(
        "packed18", "r3_18cls_packed_pipeline.jsonl", "packed",
        (("data.name=packed", *MODEL18, "data.device_augment=true",
          "train.steps_per_call=8"),),
        steps_per_epoch=32,
        bands=(("mAP@0.25", 0.05), ("mAP@0.5", 0.05))),
    # r3_outdoor_synthetic: 48 + 12 KITTI-format scenes, B2 in the loader;
    # two auto-resumes. The log's first leg has a train line every 60 steps
    # and an eval every 50 epochs, the later legs every 120 and 100
    "R3": Recipe(
        "outdoor", "r3_outdoor_synthetic.jsonl", "outdoor",
        tuple(("preset=outdoor", "data.device_preproc=true",
               "train.batch_size=8", f"train.eval_every={every}",
               f"train.log_every={log}", f"train.num_epochs={epochs}")
              for epochs, every, log in ((300, 50, 60), (1200, 100, 120),
                                         (2000, 100, 120))),
        steps_per_epoch=6,
        bands=(("mAP@0.25", 0.06),)),
}


def read_jsonl(path) -> list[dict]:
    return [json.loads(line) for line in Path(path).read_text().splitlines()
            if line.strip()]


def evals_by_epoch(records: list[dict]) -> dict[int, dict]:
    """{epoch: its eval record} (a later record of an epoch wins)."""
    return {r["eval/epoch"]: r for r in records if "eval/epoch" in r}


def compare_curves(port: list[dict], reference: list[dict],
                   bands) -> dict:
    """Hold the port's log records to the reference's, both as the train
    entry prints them. For each (metric, band) in `bands`, the port's mean
    `eval/<metric>` over the reference's eval epochs in the last quarter
    (epochs >= 75% of the reference's last eval epoch + 1) must reach the
    reference's mean there less the band. The verdict is "incomplete"
    where the port lacks an eval epoch of the reference's, else "pass" or
    "miss". Beside the bars, without one: the best mAP@0.25 and its epoch,
    the last-quarter means of AR@0.25 and val_loss, and the mean
    train/loss over the last 10% of logged train steps."""
    ref_evals, port_evals = evals_by_epoch(reference), evals_by_epoch(port)
    epochs = sorted(ref_evals)
    missing = [e for e in epochs if e not in port_evals]
    quarter = [e for e in epochs if e >= 0.75 * (epochs[-1] + 1)]

    def quarter_mean(evals, name):
        values = [evals[e][f"eval/{name}"] for e in quarter if e in evals]
        return float(np.mean(values)) if len(values) == len(quarter) else None

    def best(evals):
        at = [e for e in epochs if e in evals]
        if not at:
            return None
        top = max(at, key=lambda e: evals[e]["eval/mAP@0.25"])
        return {"epoch": top, "mAP@0.25": evals[top]["eval/mAP@0.25"]}

    def tail_loss(records):
        losses = [r["train/loss"] for r in records if "train/loss" in r]
        tail = losses[-max(1, int(np.ceil(0.1 * len(losses)))):]
        return float(np.mean(tail)) if losses else None

    bars = {}
    for name, band in bands:
        ref_mean = quarter_mean(ref_evals, name)
        port_mean = quarter_mean(port_evals, name)
        bar = ref_mean - band
        bars[name] = {"reference": ref_mean, "port": port_mean,
                      "band": band, "bar": bar,
                      "pass": port_mean is not None and port_mean >= bar}
    side = {"best": {"reference": best(ref_evals), "port": best(port_evals)},
            "train/loss last 10%": {"reference": tail_loss(reference),
                                    "port": tail_loss(port)}}
    for name in ("AR@0.25", "val_loss"):
        side[name] = {"reference": quarter_mean(ref_evals, name),
                      "port": quarter_mean(port_evals, name)}
    if missing:
        verdict = "incomplete"
    else:
        verdict = "pass" if all(b["pass"] for b in bars.values()) else "miss"
    return {"verdict": verdict, "eval_epochs": epochs,
            "last_quarter": quarter, "missing": missing, "bars": bars,
            "side_by_side": side}


def comparison_text(name: str, result: dict) -> str:
    def num(v):
        return "-" if v is None else f"{v:.4f}"

    lines = [f"{name}: {result['verdict']} (last-quarter evals at epochs "
             f"{result['last_quarter']}"
             + (f"; missing epochs {result['missing']}"
                if result["missing"] else "") + ")"]
    for metric, b in result["bars"].items():
        lines.append(f"  {metric}: port {num(b['port'])} vs reference "
                     f"{num(b['reference'])}, bar {num(b['bar'])} "
                     f"(band {b['band']}): "
                     + ("pass" if b["pass"] else "MISS"))
    for metric, s in result["side_by_side"].items():
        lines.append(f"  {metric}: port {s['port']} vs reference "
                     f"{s['reference']} (no bar)")
    return "\n".join(lines)


def leg_argv(recipe: Recipe, leg: int, data_root: str, ckpt_dir: str,
             seed: int) -> list[str]:
    """The train entry's argv of leg `leg` (0-based)."""
    argv = [*recipe.legs[leg], f"train.ckpt_dir={ckpt_dir}"]
    if data_root:
        argv.append(f"data.root={data_root}")
    if seed:
        argv.append(f"train.seed={seed}")
    return argv


def run(cmd: list[str]) -> None:
    print("$ python " + " ".join(cmd[1:]), flush=True)
    subprocess.run(cmd, cwd=ROOT, check=True)


def write_data(recipe: Recipe, work: Path) -> str:
    """The recipe's data root under `work`, written by the port's writers
    unless an earlier run finished it ("" for the host's synthetic
    scenes)."""
    if not recipe.data:
        return ""
    root = work / "data" / recipe.data
    out = root / "packed" if recipe.data == "packed" else root
    done = root / "written.json"
    if done.exists():
        return str(out)
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    if recipe.data == "packed":
        run([sys.executable, "-m", "tpu3dsad_torch.data.synthetic_indoor",
             f"out={root / 'scenes'}"])
        run([sys.executable, "-m", "tpu3dsad_torch.data.packed",
             "data.name=scannet", f"data.root={root / 'scenes'}",
             f"out={root / 'packed'}", "data.num_points=8192",
             "data.max_boxes=16"])
    else:
        run([sys.executable, "-m", "tpu3dsad_torch.data.synthetic_outdoor",
             f"out={root}"])
    seconds = time.perf_counter() - t0
    done.write_text(json.dumps({"seconds": seconds}))
    print(f"data written in {seconds:.1f} s", flush=True)
    return str(out)


def newest_step(ckpt_dir: Path) -> int:
    steps = [int(p.stem.split("_")[1]) for p in ckpt_dir.glob("ckpt_*.pt")]
    return max(steps, default=0)


def run_leg(argv: list[str], log: Path) -> float:
    """One process of the train entry; its stdout appended to `log`, its
    eval, best-snapshot and per-class lines echoed. Returns the wall
    seconds."""
    t0 = time.perf_counter()
    print("$ python -m tpu3dsad_torch.train " + " ".join(argv), flush=True)
    with log.open("a") as out, subprocess.Popen(
            [*TRAIN, *argv], cwd=ROOT, stdout=subprocess.PIPE,
            text=True) as proc:
        for line in proc.stdout:
            out.write(line)
            out.flush()
            if "eval/" in line or "new_best" in line:
                print(line, end="", flush=True)
    if proc.returncode:
        raise SystemExit(f"the train entry exited {proc.returncode}")
    return time.perf_counter() - t0


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def run_recipe(key: str, legs, seed: int, work: Path, log_dir: Path) -> dict:
    """Run `legs` (0-based) of recipe `key`, then compare its whole log
    with the reference's; returns its summary entry."""
    recipe = RECIPES[key]
    name = recipe.name + (f"_seed{seed}" if seed else "")
    data_root = write_data(recipe, work)
    ckpt = work / name / "ckpt"
    log = log_dir / f"{name}.jsonl"
    log_dir.mkdir(parents=True, exist_ok=True)
    summary_path = log_dir / "summary.json"
    summary = (json.loads(summary_path.read_text())
               if summary_path.exists() else {})
    entry = summary.get(name, {}) if legs[0] else {}
    if legs[0] == 0:  # a new run
        shutil.rmtree(ckpt, ignore_errors=True)
        log.unlink(missing_ok=True)
    else:
        want = recipe.epochs(legs[0] - 1) * recipe.steps_per_epoch
        if newest_step(ckpt) != want:
            raise SystemExit(f"leg {legs[0] + 1} resumes from step {want}: "
                             f"{ckpt} holds step {newest_step(ckpt)}")
    seconds = dict(entry.get("leg_seconds", {}))
    for leg in legs:
        argv = leg_argv(recipe, leg, data_root, str(ckpt), seed)
        seconds[str(leg + 1)] = run_leg(argv, log)
        want = recipe.epochs(leg) * recipe.steps_per_epoch
        if newest_step(ckpt) != want:
            raise SystemExit(f"leg {leg + 1} ended at step "
                             f"{newest_step(ckpt)}, not {want}")
    result = compare_curves(read_jsonl(log),
                            read_jsonl(REFERENCE_DIR / recipe.reference),
                            recipe.bands)
    print(comparison_text(name, result), flush=True)
    entry = {"recipe": key, "reference": recipe.reference,
             "steps": newest_step(ckpt), "k": recipe.k, "seed": seed,
             "card": card_line(), "leg_seconds": seconds, **result}
    summary[name] = entry
    summary_path.write_text(json.dumps(summary, indent=1, sort_keys=True)
                            + "\n")
    return entry


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("recipe", choices=sorted(RECIPES))
    ap.add_argument("--leg", type=int, default=0,
                    help="run this leg (1-based) alone")
    ap.add_argument("--seed", type=int, default=0, help="train.seed")
    ap.add_argument("--work", type=Path, default=WORK_DIR)
    ap.add_argument("--log-dir", type=Path, default=LOG_DIR)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chip_recipes.py trains on the card: torch.cuda "
                         "finds no device")
    recipe = RECIPES[args.recipe]
    if not 0 <= args.leg <= len(recipe.legs):
        raise SystemExit(f"{args.recipe} has legs 1-{len(recipe.legs)}")
    legs = ([args.leg - 1] if args.leg else list(range(len(recipe.legs))))
    print(card_line(), flush=True)
    args.work.mkdir(parents=True, exist_ok=True)
    entry = run_recipe(args.recipe, legs, args.seed, args.work, args.log_dir)
    name = recipe.name + (f"_seed{args.seed}" if args.seed else "")
    print(f"{name}: {entry['verdict']} in {entry['steps']} steps, leg "
          f"seconds {entry['leg_seconds']}", flush=True)


if __name__ == "__main__":
    main()
