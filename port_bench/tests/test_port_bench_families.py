"""The model family path (`families/<reference>.py`) against frozen copies of
what the train and eval kinds computed before they took it from the family:
for the four cells at the `_tiny` sizes, the port's TrainConfig field for
field, the train stack and six steps of draws bit for bit on two seeds, and
a step's counts exactly (at the full sizes too).  And the train kind runs in
the program's deterministic mode exactly when the configuration's `program`
asks for it."""
import dataclasses

import pytest
import torch

from port_bench.lib import harness, plants, synth
from _tiny import entry, judged, tiny_context

CELLS = ["fundus.train", "prostate.train", "fundus.eval", "prostate.eval"]


def frozen_train_config(c, device, save_path, data_root="unused"):
    from ramdsir_tpu_torch.config import TrainConfig

    return TrainConfig(
        data_root=data_root, dataset=c["dataset"], lr=c["lr"], epochs=c["epochs"],
        domain_idxs=tuple(c["domain_idxs"]), test_domain_idx=c["test_domain_idx"],
        in_channels=c["in_channels"], num_classes=c["num_classes"], lambda_rec=c["lambda_rec"],
        ram=c["ram"], rec=c["rec"], is_out_domain=c["is_out_domain"], consistency=c["consistency"],
        consistency_type=c["consistency_type"], image_size=c["image_size"], compute_dtype=c["compute_dtype"],
        test_batch_size=c["test_batch_size"], log_images_every=c["log_images_every"], num_devices=1,
        save_path=save_path, device=device,
    )


def frozen_step_draws(gen, b, crop):
    d = {}
    if crop:
        d["crop_apply"] = torch.rand(b, generator=gen) < 0.5
        d["crop_u"] = 1.0 + 0.5 * torch.rand(b, 2, generator=gen)
        d["crop_off"] = torch.rand(b, 2, generator=gen)
    d["ratio"] = torch.randint(1, 11, (b,), generator=gen).float() / 10.0
    return d


def frozen_make_data(c, seed, device):
    s = c["image_size"]
    sizes = [int(n) for n in c["train_per_domain"]]
    if c["dataset"] == "fundus":
        images, masks = synth.fundus_pairs(seed, sum(sizes), s, device)
    else:
        images, masks = synth.prostate_slices(seed, sum(sizes), s, device)
    return {"images": images, "masks": masks, "sizes": sizes}


def frozen_reference_data(c, data):
    out = {"images": torch.from_numpy(data["images"]), "masks": torch.from_numpy(data["masks"])}
    if c["dataset"] == "fundus":
        out["donors"] = out["images"]
    return out


# lib.counts.step_counts of the configuration files, read before the family path
FROZEN_COUNTS = {
    ("fundus", "full"): {"flops": 1118469881856.0, "norm_bytes": 9678356480.0, "upsample_bytes": 1572864000,
                         "ram_mix_bytes": 1273024},
    ("fundus", "tiny"): {"flops": 17476091904.0, "norm_bytes": 151224320.0, "upsample_bytes": 24576000,
                         "ram_mix_bytes": 26944},
    ("prostate", "full"): {"flops": 1572848271360.0, "norm_bytes": 13610188800.0, "upsample_bytes": 2211840000,
                           "ram_mix_bytes": 1801840},
    ("prostate", "tiny"): {"flops": 10922557440.0, "norm_bytes": 94515200.0, "upsample_bytes": 15360000,
                           "ram_mix_bytes": 16840},
}


@pytest.mark.parametrize("workload", CELLS)
def test_the_family_builds_the_same_train_config(workload, tmp_path):
    ctx = tiny_context(workload, str(tmp_path))
    for args in [("cpu", "run"), ("cuda:0", "/x/run", "/x")]:
        got = ctx.family.program_config(ctx.cfg, *args)
        assert dataclasses.asdict(got) == dataclasses.asdict(frozen_train_config(ctx.cfg, *args))


@pytest.mark.parametrize("workload", CELLS)
def test_the_family_makes_the_same_data_and_draws(workload, tmp_path):
    ctx = tiny_context(workload, str(tmp_path))
    c, b = ctx.cfg, sum(ctx.cfg["batch_size_list"])
    for seed in (7, 3000000019):
        got, want = ctx.family.make_data(c, seed, "cpu"), frozen_make_data(c, seed, "cpu")
        assert got["sizes"] == want["sizes"]
        for k in ("images", "masks"):
            assert got[k].dtype == want[k].dtype and (got[k] == want[k]).all()
        got_ref, want_ref = ctx.family.reference_data(c, got), frozen_reference_data(c, want)
        assert sorted(got_ref) == sorted(want_ref)
        assert all(torch.equal(got_ref[k], want_ref[k]) for k in want_ref)
        g, w = torch.Generator().manual_seed(seed), torch.Generator().manual_seed(seed)
        for _ in range(6):
            dg, dw = ctx.family.step_draws(c, g, b), frozen_step_draws(w, b, c["dataset"] == "fundus")
            assert list(dg) == list(dw) and all(torch.equal(dg[k], dw[k]) for k in dw)


@pytest.mark.parametrize("workload", CELLS)
def test_the_family_counts_the_same_work(workload, tmp_path):
    from port_bench.lib import spec

    ctx = tiny_context(workload, str(tmp_path))
    name = entry(workload)["config"]
    full = spec.config(spec.benchmark(), name)
    assert ctx.family.step_counts(ctx.cfg) == FROZEN_COUNTS[(name, "tiny")]
    assert ctx.family.step_counts(full) == FROZEN_COUNTS[(name, "full")]


@pytest.mark.parametrize("deterministic", [True, None])
def test_the_train_kind_runs_in_deterministic_mode_as_the_program_asks(deterministic, tmp_path):
    import ramdsir_tpu_torch.train.steps as steps

    ctx = tiny_context("fundus.train", str(tmp_path))
    if deterministic is not None:
        ctx.cfg["program"] = {"deterministic": deterministic}
    seen = []
    gather = steps.gather_and_augment

    def seen_gather(*args):
        seen.append(torch.are_deterministic_algorithms_enabled())
        return gather(*args)

    p = plants.Patches()
    try:
        p.set(steps, "gather_and_augment", seen_gather)
        out = harness.run_cell(ctx)
    finally:
        p.undo()
    assert seen and set(seen) == {bool(deterministic)}
    assert not torch.are_deterministic_algorithms_enabled()
    correct, got = judged("fundus.train", out["check"])
    assert correct, got
