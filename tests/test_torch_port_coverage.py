"""The port does all the JAX package does: every public module-level def
and class of `ramdsir_tpu/`, and every public method of its public classes,
read with `ast` (nothing is imported), has a counterpart of the same name in
the port's module of the same path, or a row in NOT_BY_NAME below with its
reason: no counterpart by design, or the port's name for it ("see")."""
import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG, PORT_PKG = "ramdsir_tpu", "ramdsir_tpu_torch"

DESIGN = "no counterpart by design"
# JAX name (module path, dotted) -> (kind, reason); kind "see" names the
# port's counterpart as "module.path:Name[.method]", which must exist
NOT_BY_NAME = {
    # the TPU space-to-depth layout, pinned equal to s2d_levels=0: the port runs the plain topology
    **{f"models.s2d.{n}": (DESIGN, "TPU lane-layout transform, numerics pinned equal to s2d_levels=0")
       for n in ("pack", "unpack", "pool2x2", "upsample2x_into", "block_kernel", "repeat4", "down_kernel",
                 "packconv2", "S2DConv", "S2DConvDown", "S2DUpConv")},
    "utils.cache.enable_persistent_cache": (DESIGN, "JAX's compile cache; the port's builds are keyed on their source's hash"),
    # utils.logging.DeviceMetricsRing has its counterpart by name, so no row.  The scan windows'
    # functions are nested in the JAX package (train/steps.py `scan_train_steps` in make_train_step,
    # train/loop.py `run_scan_segment` in fit), so the walk does not see them; their counterparts are
    # train.steps:ScanTrainSteps (make_train_step(..., scan=True)) and the `run_scan_segment` in
    # train.loop:fit, with train.loop:scan_window_size for the choice of W.
    # the device mesh: the port's data parallelism is parallel/mesh.rank_rows and all_reduce_*
    **{f"parallel.mesh.{n}": (DESIGN, "jax.sharding mesh helper; the port shards with parallel.mesh.rank_rows and "
                                      "reduces with all_reduce_sum / all_reduce_grads")
       for n in ("get_mesh", "shard_batch", "batch_sharding", "replicated")},
    "parallel.distributed.global_data_mesh": (DESIGN, "jax.sharding mesh over every host's devices; the port's "
                                                      "ranks are one process group"),
    # torch -> flax: the port reads the reference's .pth itself
    "utils.torch_compat.torch_sd_to_flax": (DESIGN, "torch state dicts into flax trees; the port loads them as they are"),
    "utils.torch_compat.import_torch_checkpoint": (DESIGN, "the port reads the reference's .pth itself "
                                                           "(train.checkpoint:load_torch_checkpoint)"),
    # the same thing under the port's own name
    "ops.ram_pallas.mix_spectrum_pallas": ("see", "ops.ram_mix:mix_spectrum"),
    "models.norm.Norm": ("see", "models.unet:_norm"),
    "models.unet.kaiming_normal_fanout": ("see", "models.unet:init_weights"),
    "models.unet.torch_conv_bias_init": ("see", "models.unet:init_weights"),
    "train.loop.build_train_loaders": ("see", "train.loop:build_train_pipeline"),
    "train.state.adam_optimizer": ("see", "train.state:init_state"),
    "train.checkpoint.BestKeeper.save_final": ("see", "train.loop:fit"),
    "train.checkpoint.save_run_config": ("see", "train.loop:save_run_config"),
    "native.largest_cc_fillhole_native": ("see", "native:largest_cc_fillhole"),
    "native.largest_cc_nd_native": ("see", "native:largest_cc_nd"),
    "native.surface_distances_native": ("see", "native:surface_distances"),
}


def _modules(pkg):
    """{dotted module path under the package: file}."""
    root = os.path.join(REPO, pkg)
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(d, f), root)[:-3].replace(os.sep, ".")
                out[rel[: -len(".__init__")] if rel.endswith("__init__") else rel] = os.path.join(d, f)
    return out


def _classes_and_defs(path):
    """({class: {method names, its bases' in the module included}}, {top-level names})."""
    tree = ast.parse(open(path).read())
    classes, names, bases = {}, set(), {}
    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            classes[node.name] = {n.name for n in node.body if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
            bases[node.name] = [b.id for b in node.bases if isinstance(b, ast.Name)]
            names.add(node.name)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update(a.asname or a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))

    def methods(cls, seen=()):
        out = set(classes.get(cls, ()))
        for b in bases.get(cls, ()):
            if b in classes and b not in seen:
                out |= methods(b, seen + (cls,))
        return out

    return {c: methods(c) for c in classes}, names


def _public_api(path):
    """The dotted names of the public module-level defs and classes, and of
    the public methods of the public classes."""
    tree = ast.parse(open(path).read())
    out = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)) and not node.name.startswith("_"):
            out.append(node.name)
            if isinstance(node, ast.ClassDef):
                out += [f"{node.name}.{n.name}" for n in node.body
                        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) and not n.name.startswith("_")]
    return out


def _has(port_modules, module, name):
    if module not in port_modules:
        return False
    classes, names = _classes_and_defs(port_modules[module])
    cls, _, method = name.partition(".")
    return cls in names and (not method or method in classes.get(cls, ()))


def test_every_public_name_of_the_jax_package_has_a_counterpart_or_a_reason():
    jax_modules, port_modules = _modules(JAX_PKG), _modules(PORT_PKG)
    missing, counted = [], 0
    for module, path in sorted(jax_modules.items()):
        for name in _public_api(path):
            counted += 1
            key = f"{module}.{name}"
            if f"{module}.{name.split('.')[0]}" in NOT_BY_NAME and "." in name:
                continue  # a method of a class with a row
            if key in NOT_BY_NAME:
                assert not _has(port_modules, module, name), f"{key} has a counterpart now: drop its table row"
                continue
            if not _has(port_modules, module, name):
                missing.append(key)
    assert counted > 200, counted  # the walk saw the package (246 names)
    assert not missing, "no counterpart and no reason:\n" + "\n".join(missing)


@pytest.mark.parametrize("key", sorted(NOT_BY_NAME))
def test_each_table_row_names_something_real(key):
    """Each row is a public name of the JAX package, with a one-line reason;
    a "see" row's target exists in the port."""
    jax_modules, port_modules = _modules(JAX_PKG), _modules(PORT_PKG)
    kind, reason = NOT_BY_NAME[key]
    parts = key.split(".")
    module = next(m for m in (".".join(parts[:i]) for i in range(len(parts) - 1, 0, -1)) if m in jax_modules)
    name = key[len(module) + 1 :]
    assert name in _public_api(jax_modules[module]), key
    assert kind in (DESIGN, "see") and reason and "\n" not in reason
    if kind == "see":
        target_module, _, target = reason.partition(":")
        assert _has(port_modules, target_module, target), reason
