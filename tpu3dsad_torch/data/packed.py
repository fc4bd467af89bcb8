"""Packed, memory-mapped splits and the double-buffered copy to the device
(tpu3dsad/data/packed.py).

The per-scene loaders do real work per scene: file reads, instance-to-box
matching, vote targets, KITTI's crop and FPS. Packing does that work once
and freezes the padded, fixed-shape training dicts into flat arrays; a
training batch is then a fancy index over page-cached memmaps, and
augmentation runs in the train step on the card (data.device_augment,
which works on exactly these padded dicts).

Layout of a packed split directory, the reference's (a split packed by
either package reads identically in the other):

  header.json   {"num_scenes": S, "keys": {name: {"shape": [...],
                 "dtype": "float32"}}, "class_names": [...],
                 "mean_sizes": [[...]], "pack_seed": int,
                 "source_dataset": "scannet"}
  <key>.npy     array [S, *shape] of dtype, C order

Use:
  python -m tpu3dsad_torch.data.packed data.name=scannet \\
      data.root=/d/scannet out=/d/scannet_packed     # train + val
  then train with data.name=packed data.root=/d/scannet_packed
  data.device_augment=true

Scene i is loaded with np.random.default_rng(pack_seed + i), so a pack is
reproducible and bitwise the source loader's scenes.
"""

from __future__ import annotations

import json
import os
import sys
from collections import deque

import numpy as np
import torch

from tpu3dsad_torch.data.pipeline import iter_val_batches
from tpu3dsad_torch.parallel.mesh import batch_sharding

_HEADER = "header.json"


def _scene_lists(dataset):
    """(train_items, val_items) of a per-scene loader."""
    if hasattr(dataset, "train_scans"):
        return dataset.train_scans, dataset.val_scans
    return dataset.train_items, dataset.val_items


def pack_split(dataset, items, out_dir: str, pack_seed: int = 0,
               source_dataset: str = "") -> int:
    """Freeze `items` ((dir, id) pairs of `dataset`) into `out_dir`.
    Returns the scene count; an empty split writes nothing."""
    if not items:
        return 0
    os.makedirs(out_dir, exist_ok=True)
    mm, keys = {}, None
    for i, it in enumerate(items):
        scene = dataset._load_scene(*it, np.random.default_rng(pack_seed + i),
                                    False)
        if keys is None:
            keys = {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                    for k, v in scene.items()}
            for k, v in scene.items():
                mm[k] = np.lib.format.open_memmap(
                    os.path.join(out_dir, f"{k}.npy"), mode="w+",
                    dtype=v.dtype, shape=(len(items),) + v.shape)
        if set(scene) != set(keys):
            raise ValueError(
                f"scene {it} keys {sorted(scene)} != first scene's "
                f"{sorted(keys)} — mixed datasets cannot pack")
        for k, v in scene.items():
            mm[k][i] = v
    for m in mm.values():
        m.flush()
    header = {
        "num_scenes": len(items),
        "keys": keys,
        "class_names": list(dataset.class_names),
        "mean_sizes": np.asarray(dataset.mean_sizes).tolist(),
        "pack_seed": pack_seed,
        # the augmentation on the card takes the source dataset's recipe
        "source_dataset": source_dataset,
    }
    with open(os.path.join(out_dir, _HEADER), "w") as f:
        json.dump(header, f)
    return len(items)


def pack_dataset(dataset, out_root: str, pack_seed: int = 0,
                 source_dataset: str = "") -> dict:
    """Pack both splits under `<out_root>/{train,val}`; returns the counts.
    source_dataset defaults to the dataset's data.name."""
    if not source_dataset:
        cfg = getattr(dataset, "cfg", None)
        source_dataset = cfg.data.name if cfg is not None else ""
    train_items, val_items = _scene_lists(dataset)
    return {
        split: pack_split(dataset, items, os.path.join(out_root, split),
                          pack_seed, source_dataset=source_dataset)
        for split, items in (("train", train_items), ("val", val_items))
    }


class PackedSplit:
    """Memory-mapped view of one packed split."""

    def __init__(self, path: str):
        with open(os.path.join(path, _HEADER)) as f:
            self.header = json.load(f)
        self.num_scenes = self.header["num_scenes"]
        self._arr = {k: np.load(os.path.join(path, f"{k}.npy"), mmap_mode="r")
                     for k in self.header["keys"]}

    def __len__(self):
        return self.num_scenes

    def scene(self, i: int) -> dict:
        return {k: a[i] for k, a in self._arr.items()}

    def gather(self, idx) -> dict:
        """The batch dict of scenes `idx`: one bulk copy a key."""
        idx = np.asarray(idx)
        return {k: a[idx] for k, a in self._arr.items()}


class PackedDetectionDataset:
    """data.name=packed: the dataset protocol over `<data.root>/{train,val}`
    packed splits. The split must match data.num_points, data.max_boxes
    and data.use_color, or it raises."""

    def __init__(self, cfg):
        self.cfg = cfg
        root = cfg.data.root
        train_dir = os.path.join(root, "train")
        if not os.path.isfile(os.path.join(train_dir, _HEADER)):
            raise FileNotFoundError(
                f"data.root={root!r} has no packed train split — create one "
                "with python -m tpu3dsad_torch.data.packed (see module "
                "docstring)")
        self.train = PackedSplit(train_dir)
        val_dir = os.path.join(root, "val")
        self.val = (PackedSplit(val_dir)
                    if os.path.isfile(os.path.join(val_dir, _HEADER))
                    else None)
        h = self.train.header
        # where the scenes came from: the augmentation recipe on the card
        self.source_dataset = h.get("source_dataset") or "scannet"
        self.class_names = h["class_names"]
        self.num_classes = len(self.class_names)
        self.mean_sizes = np.asarray(h["mean_sizes"], np.float32)
        n_pts = h["keys"]["points"]["shape"][0]
        if n_pts != cfg.data.num_points:
            raise ValueError(
                f"packed split holds {n_pts}-point scenes but "
                f"data.num_points={cfg.data.num_points} — repack or match")
        if "gt_centers" in h["keys"]:
            n_boxes = h["keys"]["gt_centers"]["shape"][0]
            if n_boxes != cfg.data.max_boxes:
                raise ValueError(
                    f"packed split holds {n_boxes}-box scenes but "
                    f"data.max_boxes={cfg.data.max_boxes} — repack or match")
        has_feats = "point_features" in h["keys"]
        if cfg.data.use_color != has_feats:
            raise ValueError(
                f"packed split was built {'with' if has_feats else 'without'}"
                f" point_features but data.use_color={cfg.data.use_color} — "
                "repack or match")

    def steps_per_epoch(self, batch_size: int) -> int:
        return max(1, len(self.train) // batch_size)

    def train_batch(self, rng: np.random.Generator, batch_size: int) -> dict:
        picks = rng.choice(len(self.train), batch_size,
                           replace=len(self.train) < batch_size)
        return self.train.gather(picks)

    def val_batches(self, rng: np.random.Generator, batch_size: int):
        split = self.val or self.train
        yield from iter_val_batches(list(range(len(split))), split.scene,
                                    batch_size)


def device_prefetch(batches, device="cuda", depth: int = 2, *, mesh=None,
                    stacked: bool = False):
    """Numpy batch dicts -> dicts of tensors on `device`, the card unless
    the caller asks for the CPU, in order.

    On the card the copies of up to `depth` batches are in flight ahead of
    the consumer: each batch is copied into pinned host buffers, then to
    the card with non_blocking copies on a side stream, and its copy's
    event is recorded. A batch is handed over only after the consumer's
    stream is made to wait on that event, and its tensors are recorded on
    the consumer's stream, so the allocator keeps them until the
    consumer's work on them is done. A pinned buffer is released only
    after its copy's event has completed.

    stacked=True marks [k, B, ...] blocks of k steps
    (train.steps_per_call). With a mesh (parallel/mesh.py), each batch
    keeps this rank's rows on the mesh's 'data' axis before it is copied:
    axis 0 of a batch, axis 1 of a stacked block (the reference's
    batch_axis_index=1); every rank reads the same global batches."""
    if mesh is not None:
        sharding = batch_sharding(mesh, "data", 1 if stacked else 0)
        batches = ({k: sharding(v) for k, v in b.items()} for b in batches)
    device = torch.device(device)
    if device.type == "cuda":
        return _prefetch_cuda(batches, device, depth)
    return ({k: torch.from_numpy(np.asarray(v)).to(device)
             for k, v in b.items()} for b in batches)


def _prefetch_cuda(batches, device, depth: int):
    stream = torch.cuda.Stream(device)
    ahead: deque = deque()  # (batch on the card, its copy's event)
    pinned: deque = deque()  # (copy event, host buffers) until it completes

    def hand_over(batch, copied):
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(copied)
        for t in batch.values():
            t.record_stream(consumer)
        return batch

    try:
        for b in batches:
            while pinned and pinned[0][0].query():
                pinned.popleft()
            host = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                    for k, v in b.items()}
            with torch.cuda.stream(stream):
                batch = {k: t.to(device, non_blocking=True)
                         for k, t in host.items()}
                copied = torch.cuda.Event()
                copied.record(stream)
            ahead.append((batch, copied))
            pinned.append((copied, host))
            if len(ahead) > depth:
                yield hand_over(*ahead.popleft())
        while ahead:
            yield hand_over(*ahead.popleft())
    finally:
        for copied, _ in pinned:
            copied.synchronize()


def main(argv):
    from tpu3dsad_torch.config import parse_cli
    from tpu3dsad_torch.data import get_dataset

    out = None
    rest = []
    for a in argv:
        if a.startswith("out="):
            out = a[len("out="):]
        else:
            rest.append(a)
    if not out:
        raise SystemExit(
            "usage: python -m tpu3dsad_torch.data.packed data.name=<ds> "
            "data.root=<src> out=<dst> [overrides...]")
    cfg = parse_cli(rest)
    counts = pack_dataset(get_dataset(cfg), out, source_dataset=cfg.data.name)
    print(json.dumps({"packed": counts, "out": out}))


if __name__ == "__main__":
    main(sys.argv[1:])
