"""The rest of tests/test_torch_port_step_configs.py's configurations
(`--lambda_rec 0.3`, `--is_out_domain`, `--activation leaky_relu`), in a
file of their own so that each file stays within a minute: the same
harness, checks and bounds, which that file's docstring states."""
import pytest

from tests._torch_threads import torch_threads  # noqa: F401 (module-scoped autouse)
from tests.test_torch_port_step import check_params_and_running_stats, check_step_metrics
from tests.test_torch_port_step_configs import (
    MORE_CONFIGS,
    check_config_gradients,
    config_runs_fixture,
    for_each_seed,
    metric_keys,
)

CONFIGS = MORE_CONFIGS
config_runs = config_runs_fixture(CONFIGS)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_config_step_metrics(config_runs, name):
    run = config_runs(name)
    for_each_seed(run, lambda one: check_step_metrics(one["jax"], one["port"], metric_keys(run["cfg"])))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_config_step_gradients(config_runs, name):
    run = config_runs(name)
    for_each_seed(run, lambda one: check_config_gradients(one["jax"]["_grads"], one["port"]["_grads"], one["pallas"],
                                                          one["moved"]))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_config_step_params_and_running_stats(config_runs, name):
    run = config_runs(name)
    for_each_seed(run, lambda one: check_params_and_running_stats(*one["params"], run["cfg"].lr))
