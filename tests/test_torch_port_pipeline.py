"""The port's device-resident fundus pipeline against the JAX package's, on
the CPU: the scale-crop resampler given the same draws, the epoch plan draw
for draw, the stacked arrays, and a train step fed by index rows.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ramdsir_tpu_torch.config import TrainConfig
from ramdsir_tpu_torch.train.state import init_state
from ramdsir_tpu_torch.train.steps import make_train_step
from tests.test_torch_port_step import BSL, CFG, HW, METRICS
from tests._torch_threads import torch_threads  # noqa: F401 (module-scoped autouse)


def test_scale_crop_matches_jax():
    """The resampler and the scale-crop given the draws the JAX function
    made from its key: images to float32 rounding, masks exactly."""
    from ramdsir_tpu.data.device_pipeline import device_scale_crop as jcrop
    from ramdsir_tpu_torch.data.device_pipeline import device_scale_crop

    rng = np.random.default_rng(5)
    imgs = rng.integers(0, 256, (8, HW, HW, 3)).astype(np.uint8)
    masks = (rng.uniform(size=(8, HW, HW, 2)) > 0.5).astype(np.uint8)
    key = jax.random.PRNGKey(3)
    want_i, want_m = jax.jit(lambda i, m, k: jcrop(i, m, k, HW))(jnp.asarray(imgs), jnp.asarray(masks), key)
    k_apply, k_f, k_off = jax.random.split(key, 3)
    draws = {
        "crop_apply": torch.from_numpy(np.asarray(jax.random.bernoulli(k_apply, 0.5, (8,)))),
        "crop_u": torch.from_numpy(np.asarray(jax.random.uniform(k_f, (8, 2), minval=1.0, maxval=1.5))),
        "crop_off": torch.from_numpy(np.asarray(jax.random.uniform(k_off, (8, 2)))),
    }
    assert draws["crop_apply"].any() and not draws["crop_apply"].all()
    got_i, got_m = device_scale_crop(torch.from_numpy(imgs), torch.from_numpy(masks), draws, HW)
    # O(255) values interpolated with two orders of the same products
    np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i), atol=1e-3, rtol=1e-6)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))


def test_epoch_plan_and_arrays_match_jax(tmp_path):
    from ramdsir_tpu.data.device_pipeline import DeviceFundusPipeline as JPipeline
    from ramdsir_tpu.data.fundus import FundusMultiDataset as JDataset
    from ramdsir_tpu.data.synthetic import make_fundus_tree
    from ramdsir_tpu_torch.data.device_pipeline import DeviceFundusPipeline
    from ramdsir_tpu_torch.data.fundus import FundusMultiDataset

    base = make_fundus_tree(str(tmp_path), per_domain_train=9, per_domain_test=1, size=20)
    size, bsl = 16, [2, 3, 4]
    jds = [JDataset(base, [d], test_domain_idx=3, resize_to=size) for d in (0, 1, 2)]
    jp = JPipeline(jds, bsl, base, size, 3, is_out_domain=True, seed=7)
    tds = [FundusMultiDataset(base, [d]) for d in (0, 1, 2)]
    tp = DeviceFundusPipeline.from_tree(tds, bsl, base, size, 3, is_out_domain=True, seed=7, device="cpu")
    assert len(tp) == len(jp)
    for _ in range(3):  # epochs: reshuffles and per-epoch donor streams
        want, got = jp.epoch_plan(), tp.epoch_plan()
        for k in ("img_idx", "donor_idx"):
            np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(
        tp.device_data["images"].numpy(), np.asarray(jp.device_data["images"]).transpose(0, 3, 1, 2)
    )
    np.testing.assert_array_equal(
        tp.device_data["masks"].numpy(), np.asarray(jp.device_data["masks"]).transpose(0, 3, 1, 2)
    )
    amp = np.asarray(jp.device_data["donor_amp"])
    np.testing.assert_allclose(tp.device_data["donor_amp"].numpy(), amp, rtol=1e-5, atol=1e-6 * amp.max())


@pytest.mark.parametrize("ram", [True, False], ids=["ram", "no_ram"])
def test_train_step_gathers_from_device_data(ram):
    """With the device pipeline the step takes index rows and draws
    everything from the Generator.  With --ram the metrics carry the JAX
    step's keys; without it, the single clean forward's (loss_bce_1,
    loss_dice_1, loss, lr), as in the JAX step."""
    from ramdsir_tpu_torch.data.device_pipeline import DeviceFundusPipeline
    from ramdsir_tpu_torch.data.synthetic import fundus_arrays
    from ramdsir_tpu_torch.ops import cuda_build

    cfg = dataclasses.replace(TrainConfig(**CFG, device="cpu"), epochs=1, ram=ram, rec=ram).resolve()
    pipe = DeviceFundusPipeline.from_arrays(
        fundus_arrays(per_domain_train=4, size=HW), (0, 1, 2), BSL, 0, seed=1, device="cpu"
    )
    g = torch.Generator().manual_seed(0)
    state = init_state(cfg, g, "cpu")
    step = make_train_step(cfg, total_iters=4, batch_size_list=BSL, device_data=pipe.device_data)
    rows = list(pipe)
    metrics = [step(state, rows[i], g) for i in range(2)]
    assert state.step == 2
    keys = set(METRICS) if ram else {"loss_bce_1", "loss_dice_1", "loss", "lr"}
    assert all(set(m) == keys for m in metrics)
    assert all(np.isfinite(float(m[k])) for m in metrics for k in keys)
    # the plain version served the CPU tensors: no kernel launch
    assert not any(cuda_build.launch_counts().values())
