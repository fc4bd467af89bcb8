"""Evaluation entry point: restore a checkpoint, run the val sweep, print
AP (the reference's eval.py).

    python -m tpu3dsad_torch.eval_detector preset=outdoor data.root=DIR \\
        data.device_preproc=true train.ckpt_dir=DIR [key=value ...]

Runs on the card unless the caller asks for the CPU (`run_eval(...,
device="cpu")`). Prints one JSON line {"ckpt_step": ..., **metrics}.
Under torchrun (`python -m torch.distributed.run --nproc-per-node=P -m
tpu3dsad_torch.eval_detector ...`) each rank joins the process group and
the sweep runs data-parallel over train.mesh_shape (train_detector.
evaluate with a mesh: the same metrics; rank 0 prints).
With model.name=classifier (preset=classifier) main evaluates the
classifier instead (train_classifier.run_eval_classifier: val_acc and
val_loss). With model.name=ssd3d (preset=3dssd) the detector is 3DSSD,
built by the same factory (train_detector.build_detector), fed the KITTI
scans' intensity and parsed by its own parse; its val_loss is null (no
3DSSD loss is ported). With model.name=groupfree3d (preset=groupfree3d)
it is Group-Free 3D, from the same factory, on xyz alone, parsed by
parse_groupfree; its val_loss is null too.
"""

from __future__ import annotations

import json
import sys

from tpu3dsad_torch import train_lib
from tpu3dsad_torch.config import describe, parse_cli
from tpu3dsad_torch.data import get_dataset
from tpu3dsad_torch.eval.parse import make_parser
from tpu3dsad_torch.parallel import launch
from tpu3dsad_torch.parallel.mesh import make_mesh
from tpu3dsad_torch.train_classifier import run_eval_classifier
from tpu3dsad_torch.train_detector import build_detector, evaluate


def run_eval(cfg, *, device="cuda") -> dict:
    """Evaluate the newest checkpoint under cfg.train.ckpt_dir (one written
    by train_lib.save_checkpoint), or with eval.use_best the best-mAP
    snapshot training kept, on the val split of cfg.data; random weights,
    with a warning on stderr, where there is none."""
    train_lib.apply_runtime_config(cfg)
    dataset = get_dataset(cfg, device=device)
    model = build_detector(cfg, dataset.mean_sizes, device=device)
    step = train_lib.restore_checkpoint(cfg.train.ckpt_dir, model, None,
                                        for_eval=True,
                                        use_best=cfg.eval.use_best)
    if step == 0:
        print("WARNING: no checkpoint found — evaluating random weights",
              file=sys.stderr)
    mesh = make_mesh(cfg.train.mesh_shape, cfg.train.mesh_axes)
    eval_step = train_lib.make_detector_eval_step(model, cfg, mesh)
    parse = make_parser(cfg, model.mean_sizes)
    out = {"ckpt_step": step,
           **evaluate(cfg, model, dataset, eval_step, parse, mesh=mesh)}
    if mesh.rank == 0:
        print(json.dumps(out), flush=True)
    return out


def main(argv) -> dict:
    cfg = parse_cli(argv)
    print(describe(cfg), file=sys.stderr)
    if cfg.model.name == "classifier":
        return run_eval_classifier(cfg)
    with launch.ranks_from_env() as ranked:
        if ranked is None:
            return run_eval(cfg)
        return run_eval(cfg, device=ranked)


if __name__ == "__main__":
    main(sys.argv[1:])
