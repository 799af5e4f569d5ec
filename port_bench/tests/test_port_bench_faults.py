"""A run with the timed path broken underneath comes out not correct, once
for each fault the cell can have (`lib.plants`); a sound run comes out
correct; and the control, the reference in bfloat16 put in the program's
place, fails the limits.  All at the CPU size of `_tiny` (the harness's
look for a card skipped), judged by the cells' own limit files.  One card,
so no cell has an exchange between chips to leave out."""
import pytest
import torch

from port_bench.lib import harness, plants
from _tiny import judged, tiny_context

CELLS = {"train": ["fundus.train", "prostate.train"], "eval": ["fundus.eval", "prostate.eval"]}


@pytest.mark.parametrize("workload,fault", [(w, f) for kind, ws in CELLS.items() for w in ws
                                            for f in [None] + plants.FAULTS[kind]])
def test_a_run_with_a_fault_is_not_correct(workload, fault, tmp_path):
    ctx = tiny_context(workload, str(tmp_path))
    with plants.planted(ctx.traffic["kind"], fault, ctx.device):
        out = harness.run_cell(ctx)
    correct, got = judged(workload, out["check"])
    assert correct == (fault is None), got


@pytest.mark.parametrize("workload", CELLS["train"] + CELLS["eval"])
def test_the_control_fails_the_limits(workload, tmp_path):
    ctx = tiny_context(workload, str(tmp_path))
    correct, got = judged(workload, harness.kind_module(ctx.traffic["kind"]).control(ctx, "bf16"))
    assert not correct, got


def test_a_planted_change_is_undone_after_its_run():
    import ramdsir_tpu_torch.train.evaluate as evaluate
    import ramdsir_tpu_torch.train.steps as steps

    before = (evaluate.postprocessing, steps.StepInputs.load, steps.ScanTrainSteps.__init__,
              torch.backends.cudnn.allow_tf32)
    for kind, changes in plants.KINDS.items():
        for name in changes:
            with plants.planted(kind, name, "cpu"):
                pass
    assert before == (evaluate.postprocessing, steps.StepInputs.load, steps.ScanTrainSteps.__init__,
                      torch.backends.cudnn.allow_tf32)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS["train"] + CELLS["eval"])
def test_a_short_run_on_the_card_is_correct(workload, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import json
    import subprocess
    import sys

    from port_bench.lib import spec

    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", workload, "--seed", "2718281828",
                          "--seconds", "2", "--trace", "0"], cwd=spec.ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
