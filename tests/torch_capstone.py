"""A tiny work dir of the port's ``scale_demo`` capstone for the CPU tests
of ``refresh_1m`` and ``hybrid_1m``: the hard recipe with the capstone's
flags (``--colisten-copies 1 --T 10``, so run
``scale_demo_m0.1_lr0.001_co1_T10``) at 2,000 tracks and 3 x 5 steps of
16-d features.  It imports no JAX."""

import ast
import importlib.util
import os

from gcn_song_embeddings_tpu_torch import scale_demo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
CAPSTONE = ["--hard", "--colisten-copies", "1", "--T", "10"]
TINY = ["--tracks", "2000", "--collections", "500", "--positives", "6000",
        "--feature-dim", "16", "--batches-per-epoch", "5"]


def capstone_work_dir(path: str, *extra: str) -> str:
    """Run the port's ``scale_demo`` capstone at the tiny size into
    ``path`` on the CPU; returns ``path``."""
    scale_demo.run(scale_demo.parse_args(
        [*CAPSTONE, *TINY, *extra, "--work-dir", path, "--device", "cpu"]),
        log=lambda *a: None)
    return path


def jax_script(name: str):
    """The JAX script ``scripts/<name>.py`` as a module (its JAX imports
    sit inside ``main``)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(SCRIPTS, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def script_tree(name: str) -> ast.Module:
    with open(os.path.join(SCRIPTS, f"{name}.py")) as f:
        return ast.parse(f.read())


def dict_keys(node: ast.Dict) -> set:
    """The keys a dict display can hold: its literal keys and those of
    the dicts it unpacks (``**({...} if ... else {})``)."""
    keys = set()
    for key, value in zip(node.keys, node.values):
        if key is not None:
            keys.add(key.value)
            continue
        for sub in ast.walk(value):
            if isinstance(sub, ast.Dict):
                keys |= {k.value for k in sub.keys
                         if isinstance(k, ast.Constant)}
    return keys


def assigned_dict(tree: ast.Module, name: str) -> ast.Dict:
    """The dict display first assigned to ``name`` in ``tree``."""
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == name
                        for t in node.targets)):
            return node.value
    raise AssertionError(f"no dict assigned to {name}")
