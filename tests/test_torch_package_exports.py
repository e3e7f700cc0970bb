"""Every public name a package ``__init__`` of the JAX package exports is
exported by the port's counterpart, or waits in ROADMAP's queue A.

Both trees are read by AST (the JAX package is not imported): a package's
public names are its ``__all__``, else the names its ``__init__`` binds
(relative imports, definitions, assignments) that do not start with an
underscore. The port's ``models/__init__`` exports lazily: the keys of its
``_EXPORTS`` table are its names. ``WAITING`` lists what is not ported
yet, each entry with its queue label; an entry that the port now exports
fails the test, so the list stays what it says.
"""

import ast
import importlib
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(REPO, "analytics_zoo_tpu")
PORT_PKG = os.path.join(REPO, "analytics_zoo_tpu_torch")

# package (relative path) -> (queue label, names still waiting, or None for
# a package the port has no __init__ of yet)
WAITING = {
    "analysis": ("A12", None),
    "compile": ("A12", None),
    "models/caffe": ("A9", None),
    "orca/learn/tf2": ("A9", None),
    "parallel": ("A10", None),
    "pipeline/api/onnx": ("A9", None),
    "native": ("A10", {"sharded_put"}),
    "tfpark": ("A9", {"TFNet"}),
}


def public_names(path):
    """The public names of a package ``__init__``, read by AST."""
    with open(path) as f:
        tree = ast.parse(f.read())
    names, all_names, lazy = set(), None, None
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.level > 0:
            names.update(a.asname or a.name for a in node.names)
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                if not isinstance(target, ast.Name):
                    continue
                names.add(target.id)
                if target.id == "__all__" and isinstance(node.value,
                                                         ast.List):
                    all_names = {e.value for e in node.value.elts}
                elif target.id == "_EXPORTS":
                    lazy = {k.value for k in node.value.keys}
    if all_names is not None:
        return all_names
    if lazy is not None:
        return lazy
    return {n for n in names if not n.startswith("_")}


def jax_packages():
    out = []
    for root, _, files in os.walk(JAX_PKG):
        if "__init__.py" in files:
            out.append(os.path.relpath(root, JAX_PKG).replace(os.sep, "/"))
    return sorted(out)


@pytest.mark.parametrize("package", jax_packages())
def test_port_exports_what_jax_exports(package):
    want = public_names(os.path.join(JAX_PKG, package, "__init__.py"))
    label, waiting = WAITING.get(package, (None, set()))
    port_init = os.path.join(PORT_PKG, package, "__init__.py")
    if waiting is None:
        assert not os.path.exists(port_init), \
            f"{package} is listed as waiting in {label} but the port has it"
        return
    if not want:
        return          # nothing to export (e.g. automl/model)
    assert os.path.exists(port_init), f"the port has no {package}/__init__"
    have = public_names(port_init)
    assert want - waiting <= have, sorted(want - waiting - have)
    assert not (waiting & have), \
        f"{sorted(waiting & have)} are exported now: drop them from WAITING"
    assert waiting <= want, sorted(waiting - want)


def test_waiting_lists_only_jax_packages():
    assert set(WAITING) <= set(jax_packages())


def test_lazy_model_exports_resolve():
    """The port's ``models`` package exports each name of its lazy table."""
    models = importlib.import_module("analytics_zoo_tpu_torch.models")
    for name in public_names(os.path.join(PORT_PKG, "models",
                                          "__init__.py")):
        assert getattr(models, name) is not None


def test_c1_entry_imports():
    """The reference's entry imports that failed before the re-exports."""
    from analytics_zoo_tpu_torch import OrcaConfig, OrcaContext
    from analytics_zoo_tpu_torch.ops import embedding_lookup
    from analytics_zoo_tpu_torch.orca import (init_orca_context,
                                              stop_orca_context)
    from analytics_zoo_tpu_torch.orca.learn import Estimator, TPUEstimator
    from analytics_zoo_tpu_torch.common.config import OrcaConfig as Config
    assert OrcaConfig is Config and callable(init_orca_context)
    assert callable(stop_orca_context) and callable(embedding_lookup)
    assert Estimator is not TPUEstimator and OrcaContext is not None


def test_chip_smoke_defines_each_name_once():
    """A second top-level ``def`` of a name in chip_smoke.py silently
    replaces the first for every earlier phase that calls it."""
    import collections
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = [n.name for n in tree.body
             if isinstance(n, (ast.FunctionDef, ast.ClassDef))]
    names += [t.id for n in tree.body if isinstance(n, ast.Assign)
              for t in n.targets if isinstance(t, ast.Name)]
    assert [k for k, v in collections.Counter(names).items() if v > 1] == []
