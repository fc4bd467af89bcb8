"""Raw ScanNet v2 scans -> the extracted .npy detection contract
(tpu3dsad/data/preproc_scannet.py, pure numpy; for one input it writes
byte-identical files). Each raw scan directory

  <scene>/
    <scene>_vh_clean_2.ply                    mesh vertices (xyz + rgb)
    <scene>.aggregation.json                  instances: label + segment ids
    <scene>_vh_clean_2.0.010000.segs.json     per-vertex segment id
    <scene>.txt                               meta (axisAlignment = 4x4)

with the label-map TSV `scannetv2-labels.combined.tsv` (raw_category ->
nyu40id) becomes what `data/scannet.py` reads:

  <scene>_vert.npy       float32 [N, 6]  axis-aligned xyz + rgb(0-255)
  <scene>_ins_label.npy  int32   [N]     instance id (0 = unannotated)
  <scene>_sem_label.npy  int32   [N]     nyu40 semantic id (0 = unmapped)
  <scene>_bbox.npy       float32 [G, 7]  cx cy cz dx dy dz nyu40_cls,
                                         axis-aligned, benchmark classes only

The lineage's semantics: vertices are axis-aligned before boxes are
computed; instance ids are the aggregation `objectId + 1`; an instance's
semantic id is its label through the TSV map; boxes are the min/max
extents of the instance's aligned points, kept for the 18 benchmark
classes only (per-vertex labels keep the whole nyu40 vocabulary). A scene
of more than `max_points` vertices is subsampled by
default_rng(i).choice, i the scene's position in the sorted scan list.

CLI:
  python -m tpu3dsad_torch.data.preproc_scannet scans=/data/scans \\
      labels=scannetv2-labels.combined.tsv out=/data/scannet \\
      [train_list=scannetv2_train.txt] [val_list=scannetv2_val.txt] \\
      [max_points=50000]

Scenes named in val_list go to out/val, the rest (or train_list) to
out/train; with no lists every scene is train. Exits nonzero naming the
scene and the missing file on a malformed scan.
"""

from __future__ import annotations

import json
import os
import sys
from glob import glob

import numpy as np

from tpu3dsad_torch.data.scannet import NYU40_IDS

_PLY_DTYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def read_ply_vertices(path: str) -> np.ndarray:
    """Minimal PLY reader for the `_vh_clean_2.ply` meshes: returns the
    vertex table as float32 [N, 6] (xyz + rgb; rgb zeros when the file has
    no color). Handles ascii and binary_little_endian; vertex must be the
    first element (true of every ScanNet mesh); faces are ignored."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elems = []  # (name, count, [(prop_name, np_dtype) ...])
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: truncated PLY header")
            tok = line.decode("ascii", "replace").split()
            if not tok or tok[0] == "comment":
                continue
            if tok[0] == "format":
                fmt = tok[1]
            elif tok[0] == "element":
                elems.append((tok[1], int(tok[2]), []))
            elif tok[0] == "property":
                if tok[1] == "list":
                    elems[-1][2].append((tok[-1], ("list", tok[2], tok[3])))
                else:
                    elems[-1][2].append((tok[-1], _PLY_DTYPES[tok[1]]))
            elif tok[0] == "end_header":
                break
        if fmt not in ("ascii", "binary_little_endian"):
            raise ValueError(f"{path}: unsupported PLY format {fmt!r}")
        if not elems or elems[0][0] != "vertex":
            raise ValueError(f"{path}: vertex is not the first PLY element")
        name, count, props = elems[0]
        if any(isinstance(d, tuple) for _, d in props):
            raise ValueError(f"{path}: list property on vertices")
        if fmt == "ascii":
            rows = [f.readline().split() for _ in range(count)]
            table = np.array(rows, np.float64)
            cols = {p: table[:, i] for i, (p, _) in enumerate(props)}
        else:
            dtype = np.dtype([(p, "<" + d) for p, d in props])
            buf = f.read(count * dtype.itemsize)
            if len(buf) < count * dtype.itemsize:
                raise ValueError(f"{path}: truncated vertex data")
            rec = np.frombuffer(buf, dtype, count)
            cols = {p: rec[p] for p, _ in props}
    out = np.zeros((count, 6), np.float32)
    for i, axis in enumerate("xyz"):
        if axis not in cols:
            raise ValueError(f"{path}: vertex has no {axis!r} property")
        out[:, i] = cols[axis]
    for i, chan in enumerate(("red", "green", "blue")):
        if chan in cols:
            out[:, 3 + i] = cols[chan]
    return out


def read_label_mapping(tsv_path: str, label_to: str = "nyu40id") -> dict:
    """`scannetv2-labels.combined.tsv`: raw_category → nyu40id."""
    with open(tsv_path) as f:
        header = f.readline().rstrip("\n").split("\t")
        try:
            ci, co = header.index("raw_category"), header.index(label_to)
        except ValueError as e:
            raise ValueError(f"{tsv_path}: missing TSV column: {e}") from e
        mapping = {}
        for line in f:
            row = line.rstrip("\n").split("\t")
            if len(row) > max(ci, co) and row[co].strip():
                mapping[row[ci]] = int(row[co])
    return mapping


def read_aggregation(path: str):
    """→ (object_id_to_segs {1-based id: [seg ids]}, seg groups' labels
    {1-based id: raw label})."""
    with open(path) as f:
        data = json.load(f)
    obj_segs, obj_label = {}, {}
    for group in data["segGroups"]:
        oid = int(group["objectId"]) + 1  # instance ids are 1-based
        obj_segs[oid] = [int(s) for s in group["segments"]]
        obj_label[oid] = group["label"]
    return obj_segs, obj_label


def read_segmentation(path: str) -> np.ndarray:
    """→ per-vertex segment id [N] (the over-segmentation json)."""
    with open(path) as f:
        return np.asarray(json.load(f)["segIndices"], np.int64)


def read_axis_align(meta_path: str) -> np.ndarray:
    """`axisAlignment` 4×4 from the scene meta txt; identity if absent."""
    with open(meta_path) as f:
        for line in f:
            if line.split("=")[0].strip() == "axisAlignment":
                vals = [float(v) for v in line.split("=")[1].split()]
                return np.array(vals, np.float64).reshape(4, 4)
    return np.eye(4)


def export_scene(scan_dir: str, scene: str, label_map: dict,
                 max_points: int = 50000, seed: int = 0) -> dict:
    """One raw scan directory → the four contract arrays (module docstring).

    Returns {"vert": [N,6] f32, "ins_label": [N] i32, "sem_label": [N] i32,
    "bbox": [G,7] f32}."""
    p = os.path.join(scan_dir, scene)
    verts = read_ply_vertices(p + "_vh_clean_2.ply")
    axis = read_axis_align(p + ".txt")
    obj_segs, obj_label = read_aggregation(p + ".aggregation.json")
    seg_ids = read_segmentation(p + "_vh_clean_2.0.010000.segs.json")
    n = len(verts)
    if len(seg_ids) != n:
        raise ValueError(
            f"{scene}: segs.json covers {len(seg_ids)} vertices, mesh has {n}"
        )

    xyz1 = np.concatenate([verts[:, :3], np.ones((n, 1), np.float32)], 1)
    verts[:, :3] = (xyz1 @ axis.T)[:, :3].astype(np.float32)

    sem = np.zeros(n, np.int32)
    ins = np.zeros(n, np.int32)
    boxes = []
    for oid in sorted(obj_segs):
        member = np.isin(seg_ids, obj_segs[oid])
        if not member.any():
            continue
        nyu = int(label_map.get(obj_label[oid], 0))
        ins[member] = oid
        sem[member] = nyu
        if nyu in NYU40_IDS:
            pts = verts[member, :3]
            lo, hi = pts.min(0), pts.max(0)
            boxes.append(np.concatenate([(lo + hi) / 2, hi - lo, [nyu]]))
    bbox = (
        np.stack(boxes).astype(np.float32)
        if boxes
        else np.zeros((0, 7), np.float32)
    )

    if n > max_points:
        sel = np.random.default_rng(seed).choice(n, max_points, replace=False)
        verts, ins, sem = verts[sel], ins[sel], sem[sel]
    return {"vert": verts, "ins_label": ins, "sem_label": sem, "bbox": bbox}


def _read_list(path: str | None) -> set | None:
    if not path:
        return None
    with open(path) as f:
        return {line.strip() for line in f if line.strip()}


def export_all(scans: str, out: str, labels: str, train_list=None,
               val_list=None, max_points: int = 50000) -> dict:
    """Walk `scans` (one subdirectory per scene) and write the contract
    npys under out/{train,val}. Returns {"train": n, "val": n}."""
    label_map = read_label_mapping(labels)
    train_set, val_set = _read_list(train_list), _read_list(val_list)
    scenes = sorted(
        os.path.basename(os.path.dirname(p))
        for p in glob(os.path.join(scans, "*", "*_vh_clean_2.ply"))
    )
    if not scenes:
        raise FileNotFoundError(f"no */*_vh_clean_2.ply scans under {scans}")
    counts = {"train": 0, "val": 0}
    for seed, scene in enumerate(scenes):
        if val_set is not None and scene in val_set:
            split = "val"
        elif train_set is None or scene in train_set:
            split = "train"
        else:
            continue
        arrays = export_scene(
            os.path.join(scans, scene), scene, label_map, max_points, seed
        )
        d = os.path.join(out, split)
        os.makedirs(d, exist_ok=True)
        for key, arr in arrays.items():
            np.save(os.path.join(d, f"{scene}_{key}.npy"), arr)
        counts[split] += 1
    return counts


def main(argv):
    kv = dict(a.split("=", 1) for a in argv)
    required = {"scans", "out", "labels"}
    if not required <= set(kv):
        print(__doc__)
        return 2
    try:
        counts = export_all(
            kv["scans"], kv["out"], kv["labels"],
            kv.get("train_list"), kv.get("val_list"),
            int(kv.get("max_points", 50000)),
        )
    except (OSError, ValueError, KeyError) as e:
        print(f"preproc_scannet: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"written": counts, "out": kv["out"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
