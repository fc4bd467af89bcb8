"""The plain reference agrees with the port at a toy size on the CPU:
served fields to the last bit, the training steps' loss, first gradient
and change within float32 summation order; and the control's weights
are drawn by the same names and shapes as the program's state."""

import numpy as np
import torch

from conftest import toy_config
from portbench import weights
from portbench.reference import compare, detector, training
from portbench.traffic.detection import class_mean_sizes, training_batches
from portbench.traffic.indoor import indoor_scene, padded


def port(cfg_json):
    from tpu3dsad_torch.config import Config, DataConfig, ModelConfig, \
        TrainConfig
    from tpu3dsad_torch.models.detector import SizeAdaptiveDetector

    m = {k: tuple(tuple(x) if isinstance(x, list) else x for x in v)
         if isinstance(v, list) else v for k, v in cfg_json["model"].items()}
    cfg = Config(model=ModelConfig(**m),
                 data=DataConfig(**cfg_json["data"]),
                 train=TrainConfig(**cfg_json["train"]))
    model = SizeAdaptiveDetector(cfg.model, device="cpu")
    return cfg, model


def test_detector_shapes_are_the_programs_state():
    cfg_json = toy_config("t", "sadet-scannet-40k", True)
    _, model = port(cfg_json)
    state = [(n, tuple(v.shape)) for n, v in model.state_dict().items()
             if v.is_floating_point()]
    assert list(weights.detector_shapes(cfg_json["model"]).items()) == state


def test_served_fields_equal_the_ports():
    from tpu3dsad_torch import serving

    cfg_json = toy_config("t", "sadet-sunrgbd-20k", False)
    cfg, model = port(cfg_json)
    params = weights.draw(weights.detector_shapes(cfg_json["model"]), 3,
                          "cpu")
    model.load_state_dict(params)
    rng = np.random.default_rng(0)
    scenes = [padded(indoor_scene(rng, 240), 256) for _ in range(2)]
    pts = torch.from_numpy(np.stack([s[0] for s in scenes]))
    mask = torch.from_numpy(np.stack([s[1] for s in scenes]))
    out = serving.build_inference_fn(cfg, model, model.mean_sizes)(pts, mask)
    ref = detector.serve(params, cfg_json, class_mean_sizes(4), pts, mask,
                         "fp32")
    for k, v in ref.items():
        assert torch.equal(out[k], v), k
    assert compare.slot_mismatches(out, ref) == (0, 16)


def test_train_steps_follow_the_ports():
    from tpu3dsad_torch import train_lib

    cfg_json = toy_config("t", "sadet-scannet-40k", True)
    cfg, model = port(cfg_json)
    params = weights.draw(weights.detector_shapes(cfg_json["model"]), 5,
                          "cpu")
    model.load_state_dict(params)
    pool = training_batches(np.random.default_rng(1), 3, 2, num_points=240,
                            budget=256, num_classes=4, max_boxes=64,
                            vote_candidates=3)
    batches = [{k: torch.from_numpy(v[i]) for k, v in pool.items()}
               for i in range(3)]
    opt = train_lib.make_optimizer(cfg.train, 1 << 40, model.parameters())
    step = train_lib.make_detector_steps(model, opt, cfg)
    gen = torch.Generator().manual_seed(9)
    names = [n for n, _ in model.named_parameters()]
    losses, grad1 = [], None
    for i, b in enumerate(batches):
        losses.append(float(step(b, gen, 0.5)["loss"]))
        if i == 0:
            grad1 = {n: float((m / 0.1).norm()) for n, m in zip(names, opt.mu)}
    change = {n: float((p.detach() - params[n]).norm())
              for n, p in model.named_parameters()}
    ref = training.follow(params, cfg_json, class_mean_sizes(4), batches,
                          torch.Generator().manual_seed(9), "fp32")
    gaps = compare.train_gaps({"loss": losses, "grad1": grad1,
                               "change": change}, ref)
    assert gaps["first_loss_gap"] < 1e-6
    assert gaps["first_grad_gap"] < 1e-5
    assert gaps["median_change_gap"] < 1e-5
