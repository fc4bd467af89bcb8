"""Recipe R1 of chip_recipes.py (the 18-class host-synthetic recipe) for
its first steps at full width on the CPU, in the JAX package and in the
port, from the same initial weights (the reference's, bridged) on the same
host batches, with no augmentation and exact grouping on both sides; and
the port again with each batch's scenes reversed, the same sums in another
order. A port that trains as the reference does stays as close to it as
to itself reversed. Prints each step's three losses and the two relative
gaps, then their means over windows of steps, then one JSON line.

    JAX_PLATFORMS=cpu python tests/torch_recipe_tracking.py [STEPS]
    JAX_PLATFORMS=cpu python tests/torch_recipe_tracking.py grouping

STEPS defaults to 64 (8 epochs of R1); ~17 min on 4 CPU threads.

`grouping` counts what the reference's fast grouping tier (the default,
ops_fast_grouping=True, with which its TPU runs trained) puts in a ball:
pairwise_sqdist(exact=False) takes the cross term a.b at
Precision.DEFAULT, which on the TPU rounds both operands to bf16 (one
pass), while |a|^2 and |b|^2 stay fp32. Emulated here by rounding the
operands of that product to bf16, on recipe R3's SA1 and SA2 balls (a
scene of the outdoor writer, cropped and sampled to 16384 points by FPS,
2048 and 1024 centers) and R1's SA1 (a synthetic indoor scene of 8192
points): the mean members a ball, the share of the emulated members
truly within r, and the share of the true members kept (ball query then
takes the first K of them; ~1 s).

Not a pytest file: diagnostics of the recipes' learning curves
(docs/torch_experiments/README.md).
"""

import json
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_recipes  # noqa: E402
import tpu3dsad_torch.config as tconfig  # noqa: E402
from tpu3dsad import config as jconfig  # noqa: E402
from tpu3dsad import losses as jlosses  # noqa: E402
from tpu3dsad import ops as jops  # noqa: E402
from tpu3dsad import train_lib as jtrain  # noqa: E402
from tpu3dsad.data.synthetic import class_mean_sizes, detection_batch  # noqa: E402
from tpu3dsad.models.detector import SizeAdaptiveDetector as JDetector  # noqa: E402
from tpu3dsad_torch import train_lib  # noqa: E402
from tpu3dsad_torch.models.detector import SizeAdaptiveDetector  # noqa: E402
from tpu3dsad_torch.utils.bridge import load_flax_variables  # noqa: E402

WINDOWS = ((0, 1), (1, 8), (8, 16), (16, 32), (32, 48), (48, 64))


def reference_losses(cfg, batches, spe):
    """The JAX package's losses and the initial variables (key 0)."""
    jops.set_default_impl("xla")
    jops.set_fast_grouping(False)
    jax.config.update("jax_default_matmul_precision", "highest")
    model = JDetector(cfg.model)
    variables = jax.jit(lambda key: model.init(
        key, jnp.asarray(batches[0]["points"]),
        mask=jnp.asarray(batches[0]["point_mask"]), train=False))(
            jax.random.key(0))
    sizes = class_mean_sizes(cfg.model.num_classes)

    @jax.jit
    def loss_and_grad(params, stats, batch, bn_m):
        def loss_of(p):
            ep, upd = model.apply(
                {"params": p, "batch_stats": stats}, batch["points"],
                mask=batch["point_mask"], train=True, bn_momentum=bn_m,
                mutable=["batch_stats"])
            loss, _ = jlosses.detection_loss(
                ep, batch, sizes, cfg.model.num_heading_bins,
                tuple(cfg.model.cluster_radius_bank))
            return loss, upd["batch_stats"]
        return jax.value_and_grad(loss_of, has_aux=True)(params)

    tx = jtrain.make_optimizer(cfg.train, spe)
    params, stats = variables["params"], variables["batch_stats"]
    state = tx.init(params)
    losses = []
    for i, b in enumerate(batches):
        bn_m = float(jtrain.bn_momentum_at(cfg.train, i // spe))
        (loss, stats), grads = loss_and_grad(
            params, stats, {k: jnp.asarray(v) for k, v in b.items()}, bn_m)
        updates, state = tx.update(grads, state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        losses.append(float(loss))
    return variables, losses


def port_losses(cfg, batches, spe, variables, reverse: bool):
    model = SizeAdaptiveDetector(
        cfg.model, class_mean_sizes(cfg.model.num_classes), device="cpu")
    load_flax_variables(model, variables)
    optimizer = train_lib.make_optimizer(cfg.train, spe, model.parameters())
    losses = []
    for i, b in enumerate(batches):
        batch = {k: torch.from_numpy(np.ascontiguousarray(
            v[::-1] if reverse else v)) for k, v in b.items()}
        model.train()
        optimizer.zero_grad()
        loss, _ = train_lib.detector_loss(
            model, cfg, batch, train_lib.bn_momentum_at(cfg.train, i // spe))
        loss.backward()
        optimizer.step()
        losses.append(loss.item())
    return losses


def reference_fast_sqdist(a, b):
    """pairwise_sqdist(a, b, exact=False) as the TPU computes it: the cross
    term's operands rounded to bf16, the products summed in fp32."""
    a2 = jnp.sum(a * a, axis=-1)[:, None]
    b2 = jnp.sum(b * b, axis=-1)[None, :]
    cross = jnp.einsum("mc,nc->mn", a.astype(jnp.bfloat16),
                       b.astype(jnp.bfloat16),
                       preferred_element_type=jnp.float32)
    return np.asarray(jnp.maximum(a2 + b2 - 2.0 * cross, 0.0))


def ball_membership(points, centers, radius) -> str:
    exact = ((centers[:, None, :] - points[None]) ** 2).sum(-1) < radius ** 2
    fast = reference_fast_sqdist(jnp.asarray(centers),
                                 jnp.asarray(points)) < radius ** 2
    both = (exact & fast).sum()
    return (f"members a ball exact {exact.sum(1).mean():.1f}, fast "
            f"{fast.sum(1).mean():.1f}; fast members within r "
            f"{both / max(fast.sum(), 1):.3f}; exact members kept "
            f"{both / max(exact.sum(), 1):.3f}")


def grouping() -> None:
    from tpu3dsad_torch.data import synthetic_outdoor
    from tpu3dsad_torch.data.kitti import range_crop
    from tpu3dsad_torch.ops.plain import furthest_point_sample

    def fps(x, m):
        return x[furthest_point_sample(torch.from_numpy(x)[None], m)[0]
                 .numpy()]

    rng = np.random.default_rng(0)
    cloud, _ = synthetic_outdoor.outdoor_scene(rng, 98304)
    cloud = cloud[range_crop(cloud)][:, :3].astype(np.float32)
    points = fps(cloud, 16384)
    sa1 = fps(points, 2048)
    sa2 = fps(sa1, 1024)
    print(f"R3 SA1 (r 0.8, 16384 points, 2048 centers): "
          f"{ball_membership(points, sa1, 0.8)}")
    print(f"R3 SA2 (r 1.6, 2048 points, 1024 centers): "
          f"{ball_membership(sa1, sa2, 1.6)}")
    indoor = detection_batch(rng, 1, 8192, 18, 16)["points"][0]
    print(f"R1 SA1 (r 0.2, 8192 points, 1024 centers): "
          f"{ball_membership(indoor, fps(indoor, 1024), 0.2)}")


def main(steps: int) -> None:
    torch.set_num_threads(4)
    recipe = chip_recipes.RECIPES["R1"]
    argv = [*chip_recipes.leg_argv(recipe, 0, "", "unused", 0),
            "ops_fast_grouping=false"]
    jcfg, tcfg = jconfig.parse_cli(argv), tconfig.parse_cli(argv)
    spe, n = recipe.steps_per_epoch, tcfg.data.num_points
    rng = np.random.default_rng(0)
    batches = [detection_batch(rng, tcfg.train.batch_size, n,
                               tcfg.model.num_classes, tcfg.data.max_boxes,
                               vote_candidates=tcfg.data.vote_candidates)
               for _ in range(steps)]
    out = {}
    t0 = time.perf_counter()
    variables, out["jax"] = reference_losses(jcfg, batches, spe)
    seconds = {"jax": time.perf_counter() - t0}
    for name, reverse in (("port", False), ("port_reversed", True)):
        t0 = time.perf_counter()
        out[name] = port_losses(tcfg, batches, spe, variables, reverse)
        seconds[name] = time.perf_counter() - t0
    j, p, r = (np.array(out[k]) for k in ("jax", "port", "port_reversed"))
    gap, floor = np.abs(p / j - 1), np.abs(r / p - 1)
    for i in range(steps):
        print(f"step {i + 1}: jax {j[i]:.5f} port {p[i]:.5f} reversed "
              f"{r[i]:.5f}  |port/jax - 1| {gap[i]:.3g}  |reversed/port - 1|"
              f" {floor[i]:.3g}")
    for a, b in WINDOWS:
        if b <= steps:
            print(f"steps {a + 1}-{b}: mean loss jax {j[a:b].mean():.4f} "
                  f"port {p[a:b].mean():.4f} reversed {r[a:b].mean():.4f};"
                  f" mean |port/jax - 1| {gap[a:b].mean():.4f}, mean "
                  f"|reversed/port - 1| {floor[a:b].mean():.4f}")
    print(json.dumps({"steps": steps, "seconds": seconds, **out}))


if __name__ == "__main__":
    if sys.argv[1:] == ["grouping"]:
        grouping()
    else:
        main(int(sys.argv[1]) if len(sys.argv) > 1 else 64)
