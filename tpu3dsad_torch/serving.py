"""The whole-scene inference program as a server's unit of work, and its
export (tpu3dsad/serving.py).

One call is forward + box decode + class-aware 3D NMS over a fixed-shape
batch, returning the parsed prediction fields with the post-NMS keep mask
(`InferenceProgram`). `export_detector` freezes that program, weights
included, with torch.export into one file that `load` reads back:

  * no model code, checkpoint or config is needed to serve it:
    `load(path).module()(points, mask)` under torch.no_grad() is the whole
    server;
  * FPS and ball query are the custom operators of ops/library.py, one
    node each in the program, so the loaded program launches the same
    kernels as the eager one (and needs tpu3dsad_torch.ops imported, which
    this module does, to find them);
  * the program pins its calling convention (shapes, dtypes) and is tied
    to the device type it was exported on, as the reference's artifact is
    tied to its platform.

CLI:
  python -m tpu3dsad_torch.serving ckpt=<dir> out=<model.pt2> [overrides...]
  python -m tpu3dsad_torch.serving run=<model.pt2> scene=<pts.npy> [out=<json>]

Both run on the card unless `device=cpu` is given; with no card they raise.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch
from torch import nn

from tpu3dsad_torch import ops  # noqa: F401  (registers the custom ops)
from tpu3dsad_torch.eval.parse import make_parser
from tpu3dsad_torch.utils import trace

_EXPORT_KEYS = ("center", "size", "heading", "sem_cls", "obj_prob", "keep")


class InferenceProgram(nn.Module):
    """forward(points [B,N,3], mask [B,N][, features [B,N,C]]) -> {key:
    tensor} for _EXPORT_KEYS: the detector in eval mode, then its parse
    with cfg.eval (eval/parse.py::make_parser: parse_predictions,
    parse_ssd3d for model.name='ssd3d', parse_groupfree for
    model.name='groupfree3d'). Eager serving and the export run this
    module."""

    def __init__(self, cfg, model, mean_sizes):
        super().__init__()
        mean_sizes = np.asarray(mean_sizes, np.float32)
        if not np.array_equal(mean_sizes, model.mean_sizes):
            raise ValueError("model was built with other mean_sizes")
        self.model = model.eval()
        self.mean_sizes = mean_sizes
        self.parse = make_parser(cfg, mean_sizes)

    def forward(self, points, mask, features=None):
        with trace.span("serve.program"):
            ep = self.model(points, features, mask=mask)
            parsed = self.parse(ep)
            return {k: parsed[k] for k in _EXPORT_KEYS}


def build_inference_fn(cfg, model, mean_sizes, with_features: bool = False):
    """fn(points [B,N,3], mask [B,N][, features [B,N,C]]) -> {key: tensor}
    for _EXPORT_KEYS, without gradients. with_features matches detectors
    built with data.use_color (the calling convention is part of the
    artifact).

    cfg: a Config (cfg.model, cfg.eval); model: the detector
    train_detector.build_detector makes of cfg (a SizeAdaptiveDetector,
    3DSSD, which takes its point features: with_features=True, or
    Group-Free 3D, on xyz alone) with the same mean_sizes."""
    program = InferenceProgram(cfg, model, mean_sizes)

    if with_features:
        @torch.no_grad()
        def infer(points, mask, features):
            return program(points, mask, features)
    else:
        @torch.no_grad()
        def infer(points, mask):
            return program(points, mask)

    return infer


def export_detector(cfg, model, mean_sizes, batch_size: int, path: str, *,
                    with_features: bool = False,
                    source_dataset: str = "") -> dict:
    """Export the inference program for (batch_size, cfg.data.num_points)
    on the model's device to `path` (torch.export.save). Returns a manifest,
    also written to path + ".json"."""
    program = InferenceProgram(cfg, model, mean_sizes)
    device = next(model.parameters()).device
    n = cfg.data.num_points
    channels = getattr(model, "point_features", 3)  # 3DSSD's, else colour
    args = (torch.zeros(batch_size, n, 3, device=device),
            torch.ones(batch_size, n, dtype=torch.bool, device=device))
    if with_features:
        args += (torch.zeros(batch_size, n, channels, device=device),)
    with torch.no_grad():
        exported = torch.export.export(program, args, strict=False)
    # the zeros it was traced on are no part of the program (at 32 x 20480
    # they would be half the file)
    exported.example_inputs = None
    torch.export.save(exported, path)
    manifest = {
        "batch_size": batch_size,
        "num_points": n,
        "num_classes": cfg.model.num_classes,
        "platforms": [device.type],
        "bytes": os.path.getsize(path),
        "outputs": list(_EXPORT_KEYS),
        "with_features": with_features,
        # lets the run CLI apply the SAME feature normalization the
        # training loader used (scannet stores 0-255 rgb, trained on /256)
        "source_dataset": source_dataset,
    }
    if with_features and channels != 3:
        # point features that are not the 3 colour channels (3DSSD's
        # intensity); the reference's manifest has no such key
        manifest["feature_channels"] = channels
    with open(path + ".json", "w") as f:
        json.dump(manifest, f)
    return manifest


def load(path: str) -> torch.export.ExportedProgram:
    """Read an artifact of export_detector. Call it as
    `load(path).module()(points, mask[, features])` under torch.no_grad(),
    with inputs on the device type it was exported on. Unlike the
    reference's artifact, it resolves its FPS and ball-query nodes only
    where tpu3dsad_torch.ops is imported (this module imports it)."""
    return torch.export.load(path)


def prepare_scene_batch(raw: np.ndarray, manifest: dict,
                        device="cuda") -> list:
    """Fit one raw scene [P, 3(+color)] to the artifact's fixed calling
    convention: [points, mask(, features)] on `device`, scene 0 of the
    batch. Oversized clouds subsample without replacement; short clouds
    pad with zeros + mask=False (padding must never join a ball or pollute
    a pool — duplicate-sampled "real" points would). A KITTI artifact's
    scan (manifest source_dataset "kitti", [P, 4] xyz + intensity) is fitted
    on `device` as its loader fits it for training and evaluation
    (data/kitti.py::fit_scene: range crop, FPS, pad)."""
    with trace.span("serve.prepare"):
        if manifest.get("source_dataset") == "kitti":
            return _prepare_kitti(raw, manifest, device)
        B, N = manifest["batch_size"], manifest["num_points"]
        pts = raw[:, :3].astype(np.float32)
        sel = (
            np.random.default_rng(0).choice(len(pts), N, replace=False)
            if len(pts) > N
            else np.arange(len(pts))
        )
        batch_pts = np.zeros((B, N, 3), np.float32)
        batch_pts[0, : len(sel)] = pts[sel]
        mask = np.zeros((B, N), bool)
        mask[0, : len(sel)] = True
        arrays = [batch_pts, mask]
        if manifest.get("with_features"):
            fb = np.zeros((B, N, 3), np.float32)
            if raw.shape[1] >= 6:  # color columns ride along when present
                fb[0, : len(sel)] = raw[sel, 3:6].astype(np.float32)
                if manifest.get("source_dataset") == "scannet":
                    # the scannet loader trains on rgb/256 (0-255 on disk);
                    # raw values here would be 256x out of distribution
                    fb[0] /= 256.0
            arrays.append(fb)
        return [torch.from_numpy(a).to(device) for a in arrays]


def _prepare_kitti(raw: np.ndarray, manifest: dict, device) -> list:
    """prepare_scene_batch of a KITTI scan: fit_scene on `device`, then
    scene 0 of the batch; the features (the manifest's feature_channels
    columns from column 3, where the scan has them: colour, or 3DSSD's
    intensity) ride along with the fitted rows."""
    from tpu3dsad_torch.data.kitti import fit_scene

    B, N = manifest["batch_size"], manifest["num_points"]
    scan = torch.from_numpy(np.ascontiguousarray(raw, np.float32)).to(device)
    fit = fit_scene(scan, N, device)
    points = scan.new_zeros(B, N, 3)
    points[0] = fit.points
    mask = torch.zeros(B, N, dtype=torch.bool, device=scan.device)
    mask[0] = fit.mask
    out = [points, mask]
    if manifest.get("with_features"):
        C = manifest.get("feature_channels", 3)
        features = scan.new_zeros(B, N, C)
        if scan.shape[1] >= 3 + C:
            features[0, :fit.rows.shape[0]] = scan[fit.rows, 3:3 + C]
        out.append(features)
    return out


def detections(out: dict) -> list:
    """Scene 0's kept boxes of a program's outputs as the run CLI prints
    them: {"center", "size", "heading", "score", "class"} each."""
    with trace.span("serve.detections"):
        with trace.span("serve.d2h"):
            out = {k: v.cpu().numpy() for k, v in out.items()}
        keep = out["keep"][0].astype(bool)
        return [
            {
                "center": out["center"][0][i].tolist(),
                "size": out["size"][0][i].tolist(),
                "heading": float(out["heading"][0][i]),
                "score": float(out["obj_prob"][0][i]),
                "class": int(out["sem_cls"][0][i]),
            }
            for i in np.nonzero(keep)[0]
        ]


def _run(kv: dict, device: str) -> None:
    with open(kv["run"] + ".json") as f:
        manifest = json.load(f)
    if torch.device(device).type not in manifest["platforms"]:
        raise SystemExit(f"{kv['run']} was exported for "
                         f"{manifest['platforms']}; pass device= one of them")
    program = load(kv["run"]).module()
    args = prepare_scene_batch(np.load(kv["scene"]), manifest, device=device)
    with torch.no_grad():
        out = program(*args)
    payload = json.dumps({"detections": detections(out)})
    if "out" in kv:
        with open(kv["out"], "w") as f:
            f.write(payload)
    print(payload)


def _export(kv: dict, rest: list, device: str) -> dict:
    from tpu3dsad_torch import train_lib
    from tpu3dsad_torch.config import parse_cli
    from tpu3dsad_torch.data import get_dataset
    from tpu3dsad_torch.train_detector import build_detector

    cfg = parse_cli(rest)
    train_lib.apply_runtime_config(cfg)  # the grouping tier it exports
    dataset = get_dataset(cfg, device=device)
    model = build_detector(cfg, dataset.mean_sizes, device=device)
    step = train_lib.restore_checkpoint(kv["ckpt"], model, None,
                                        for_eval=True,
                                        use_best=cfg.eval.use_best)
    if step == 0:
        raise SystemExit(
            f"no checkpoint found under {kv['ckpt']!r} — refusing to export "
            "randomly-initialized weights into a serving artifact"
        )
    manifest = export_detector(
        cfg, model, dataset.mean_sizes, cfg.train.batch_size, kv["out"],
        with_features=cfg.data.use_color or cfg.model.name == "ssd3d",
        source_dataset=cfg.data.name,
    )
    report = {"ckpt_step": step, **manifest}
    print(json.dumps(report))
    return report


def main(argv):
    """ckpt=<dir> out=<path> [overrides...]: export the newest checkpoint
    (eval.use_best: the best snapshot) of the detector that the overrides
    describe, at (train.batch_size, data.num_points); prints the manifest
    with ckpt_step. run=<path> scene=<.npy> [out=<json>]: serve one scene
    [P, 3(+color)] and print {"detections": [...]}. device=cpu runs either
    on the CPU; the default is the card."""
    kv, rest = {}, []
    for a in argv:
        key = a.split("=", 1)[0]
        if key in ("ckpt", "out", "run", "scene", "device"):
            kv[key] = a.split("=", 1)[1]
        else:
            rest.append(a)
    device = kv.get("device", "cuda")
    if "run" in kv:
        return _run(kv, device)
    if "ckpt" not in kv or "out" not in kv:
        raise SystemExit(main.__doc__)
    return _export(kv, rest, device)


if __name__ == "__main__":
    main(sys.argv[1:])
