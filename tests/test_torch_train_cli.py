"""The port's training CLI on the CPU (``eqxvision_tpu_torch.cli.train_imagenet``).

squeezenet1_0, batch 8, 56 px synthetic uint8 canvases cropped to 48, 10
classes, 3 steps an epoch: on-device augmentation with the mixup / cutmix
switch, label smoothing, the EMA, SGD with the warmup-cosine schedule.
One unbroken run of two epochs checkpoints at step 3 and step 6; the
checkpoint of step 6, loaded into a fresh state, equals the run's model,
optimiser state, schedule, EMA and generator exactly; a run resumed from
step 3 reaches step 6 with the unbroken run's model, optimiser state and
EMA exactly (the RNG states are part of the checkpoint). The schedule is
optax's ``warmup_cosine_decay_schedule``; the CLI raises without a card
unless ``--device cpu``, on the flags of later work, and on a mesh that
does not divide the world.
"""
import json
import os

import numpy as np
import optax
import pytest
import torch

from eqxvision_tpu_torch.cli import train_imagenet as cli

COMMON = [
    "--device", "cpu", "--model", "squeezenet1_0", "--synthetic", "3", "--batch-size", "8", "--canvas", "56",
    "--crop", "48", "--num-classes", "10", "--warmup-epochs", "1", "--lr", "0.01", "--ema", "0.99",
    "--mixup", "0.2", "--cutmix", "1.0", "--log-every", "1", "--epochs", "2",
]


def _same_state(a: cli.TrainState, b: cli.TrainState):
    for name, value in a.model.state_dict().items():
        torch.testing.assert_close(b.model.state_dict()[name], value, rtol=0, atol=0, msg=name)
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"] and sa["state"].keys() == sb["state"].keys()
    for i, s in sa["state"].items():
        for k, v in s.items():
            torch.testing.assert_close(sb["state"][i][k], v, rtol=0, atol=0)
    for name, value in a.ema.items():
        torch.testing.assert_close(b.ema[name], value, rtol=0, atol=0, msg=name)
    assert a.scheduler.get_last_lr() == b.scheduler.get_last_lr()


def test_train_checkpoint_and_resume(tmp_path):
    unbroken = str(tmp_path / "unbroken")
    step, ts = cli.main(COMMON + ["--ckpt-dir", unbroken, "--ckpt-every", "3"])
    assert step == 6 and sorted(os.listdir(unbroken)) == ["latest.json", "step_3", "step_6"]
    assert all(bool(torch.isfinite(p).all()) for p in ts.model.parameters())

    args = cli.build_argparser().parse_args(COMMON)
    restored = cli.build_train_state(args, torch.device("cpu"), 3)
    assert cli.load_checkpoint(os.path.join(unbroken, "step_6"), restored) == 6
    _same_state(ts, restored)
    assert torch.equal(restored.generator.get_state(), ts.generator.get_state())

    resumed = str(tmp_path / "resumed")
    os.makedirs(resumed)
    os.rename(os.path.join(unbroken, "step_3"), os.path.join(resumed, "step_3"))
    with open(os.path.join(resumed, "latest.json"), "w") as f:
        json.dump({"step": 3}, f)
    step, ts_resumed = cli.main(COMMON + ["--ckpt-dir", resumed, "--resume"])
    assert step == 6
    _same_state(ts, ts_resumed)


def test_schedule_is_optax_warmup_cosine():
    want = optax.warmup_cosine_decay_schedule(0.0, 0.5, 5, 40)
    factor = cli.warmup_cosine(5, 40)
    got = np.array([0.5 * factor(s) for s in range(45)])
    np.testing.assert_allclose(got, np.array([float(want(s)) for s in range(45)]), atol=1e-7)
    model = torch.nn.Linear(2, 2)
    opt = cli.build_optimizer(model, "sgd", 0.5, 1e-4)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, factor)
    seen = []
    for _ in range(3):  # the first update takes schedule(0), as optax's count does
        seen.append(opt.param_groups[0]["lr"])
        opt.step()
        sched.step()
    np.testing.assert_allclose(seen, [float(want(s)) for s in range(3)], atol=1e-7)
    assert [g["weight_decay"] for g in opt.param_groups] == [1e-4, 0.0]  # the weight, not the bias
    assert [len(g["params"]) for g in opt.param_groups] == [1, 1]
    with pytest.raises(ValueError, match="decay_steps"):
        cli.warmup_cosine(5, 5)


def test_without_a_card_the_default_device_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    argv = [a for a in COMMON if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cli.main(argv)


@pytest.mark.parametrize("flags, item", [(["--aa", "randaugment"], "A.12b")])
def test_later_work_raises(flags, item):
    with pytest.raises(NotImplementedError, match=item):
        cli.main(COMMON + flags)


def test_mesh_flags_in_one_process():
    """Outside a torchrun world, ``--distributed`` trains as one process
    (a world of one) and ``--mesh-model 2`` raises: two model ranks do not
    divide a world of one. tests/test_torch_parallel.py runs both in a
    world of four."""
    with pytest.raises(ValueError, match="world size"):
        cli.main(COMMON + ["--mesh-model", "2"])
    step, ts = cli.main(COMMON + ["--distributed"])
    assert step == 6 and all(bool(torch.isfinite(p).all()) for p in ts.model.parameters())
