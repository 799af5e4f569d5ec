"""The plain reference (`port_bench/reference/ramdsir.py`) against the port
at 32^2 on the CPU: a training step within step_parity's bounds (loss
relative 1e-5, parameters 2.5 x lr, running statistics rtol 1e-4 / atol
1e-5), and the eval's probabilities (1e-4), post-processed labels (equal)
and each case's Dice (1e-3)."""
import numpy as np
import pytest
import torch

from port_bench.lib import common, harness, train_cell
from _tiny import tiny_context


@pytest.mark.parametrize("workload", ["fundus.train", "prostate.train"])
def test_one_training_step_agrees_with_the_port(workload, tmp_path):
    ctx = tiny_context(workload, str(tmp_path))
    c = ctx.cfg
    data = ctx.family.make_data(c, ctx.seed, "cpu")
    weights = ctx.reference.make_weights(c, ctx.seed, "cpu")
    host = {k: v.clone() for k, v in weights.items()}
    cfg = ctx.family.program_config(c, "cpu", str(tmp_path / "run"))
    loop = train_cell.WindowLoop(c, cfg, ctx.seed, "cpu", weights, data)
    draw_state = loop.generator.get_state()
    loop.plan, loop.pos = loop.planner.epoch(), 0
    plan = {k: v[:1].copy() for k, v in loop.plan.items()}
    _, metrics = loop.window(1)
    port = common.named_state(loop.state.models)
    losses, states = train_cell.chain(ctx, c, data, host, plan, draw_state, loop.B, loop.total_iters)
    after = states[1]["tensors"]
    assert float(metrics["loss"][0]) == pytest.approx(losses[0], rel=1e-5)
    lr = c["lr"]
    for name, ref in after.items():
        if name.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(port[name], ref, rtol=1e-4, atol=1e-5)
        else:
            assert float((port[name] - ref).abs().max()) <= 2.5 * lr, name


@pytest.mark.parametrize("workload", ["fundus.eval", "prostate.eval"])
def test_the_eval_agrees_with_the_port(workload, tmp_path):
    ctx = tiny_context(workload, str(tmp_path))
    out = harness.run_cell(ctx)
    assert out["check"]["prob_gap"] <= 1e-4
    assert out["check"]["label_gap"] == 0.0 and out["check"]["ref_label_gap"] == 0.0
    assert out["check"]["dice_gap"] <= 1e-12 and out["check"]["ref_dice_gap"] <= 1e-3
    assert out["host"]["passes"] >= 1


def test_pil_bilinear_against_a_hand_computed_downscale():
    # 4 -> 2 columns: the triangle filter widened x2 puts weights 1/4, 3/4, 3/4, 1/4 on
    # (x0, x1), (x1, x2), ... normalised per output; row i: [0, 40, 80, 120]
    a = np.tile(np.array([0, 40, 80, 120], np.uint8), (1, 1))
    out = __import__("port_bench.reference.ramdsir", fromlist=["pil_bilinear"]).pil_bilinear(a, 1, 2)
    # output 0: centre 1.0, taps x=0..2 weights (0.75, 0.75, 0.25) / 1.75 -> 0*0.4286 + 40*0.4286 + 80*0.1429
    assert out.tolist() == [[int(0.5 + 40 * 0.75 / 1.75 + 80 * 0.25 / 1.75), int(0.5 + (40 * 0.25 + 80 * 0.75 + 120 * 0.75) / 1.75)]]
