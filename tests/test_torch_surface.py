"""Every public function and class of the JAX package has its port.

For each module of ``moonbit_flate_tpu/``, its public top-level functions
and classes (and the names of its ``__all__``) are read with ``ast``, so
JAX is never imported here, and the port's counterpart module, imported,
must have each one: under the same name, or under the name and module
that ``NAMES`` and ``MOVED`` give.  What the port leaves out on purpose is
in ``EXCLUDED``, each with its reason, and a test keeps that list true.
"""

import ast
import importlib
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "moonbit_flate_tpu")

# JAX module -> the port's module, where the name differs
MODULES = {
    "api/tpu": "api/cuda",
    "inflate/tpu_inflate": "inflate/cuda_inflate",
    "ops/huffman_jax": "ops/huffman_torch",
    "ops/parse_pallas": "ops/parse",
    "ops/resolve_pallas": "ops/resolve",
    "ops/walk_pallas": "ops/walk",
}
# JAX name -> the port's name, in the counterpart module
NAMES = {
    "TPUCompressor": "CUDACompressor",
    "tpu_compressor": "cuda_compressor",
    "walk_batch": "commit_walk",
    "resolve_batch_pallas": "resolve_batch",
}
# (JAX module, name) -> (the port's module, name) for a name the port
# keeps in another module
MOVED = {
    ("ops/lanes_inflate", "len_base_extra"): ("ops/tables", "length_base_extra"),
    ("ops/lanes_inflate", "dist_base_extra"): ("ops/tables", "offset_base_extra"),
}
_IN_KERNEL = ("a helper inside the Pallas kernels of the lane decode; its "
              "logic is in csrc/lanes_parse.cu and csrc/lanes_resolve.cu")
EXCLUDED = {
    ("ops/lanes_inflate", "rows_from_state"): _IN_KERNEL,
    ("ops/lanes_inflate", "state_from_rows"): (
        "the inverse of the in-kernel rows_from_state; nothing in the JAX "
        "package calls it"),
    ("ops/lanes_inflate", "chunked_gather"): _IN_KERNEL,
    ("ops/lanes_inflate", "chunked_gather_ref"): _IN_KERNEL,
    ("ops/lanes_inflate", "requeue"): _IN_KERNEL,
    ("ops/lanes_inflate", "queue_read"): _IN_KERNEL,
    ("ops/lanes_inflate", "length_decode"): _IN_KERNEL,
    ("ops/lanes_inflate", "map_lookup3"): _IN_KERNEL,
    ("ops/lanes_inflate", "entry_extract"): _IN_KERNEL,
    ("ops/dense", "take1d_stack"): "nothing in the JAX package calls it",
    ("ops/dense", "take_rows_stack"): "nothing in the JAX package calls it",
    ("ops/pipeline", "pack_units"): (
        "the plain-XLA bit pack; ops/pack.pack_units_ref is the port's plain "
        "version and ops/pack.pack_units_dense its kernel"),
}


def _jax_modules():
    """Every module of the JAX package by its path without ``.py``
    (``api/__init__`` for a package)."""
    return sorted(os.path.relpath(os.path.join(root, f), JAX_PKG)[:-3]
                  for root, _, files in os.walk(JAX_PKG)
                  for f in files if f.endswith(".py"))


def _public_names(mod):
    """Public top-level functions and classes of a JAX module, and its
    ``__all__``, read from its source."""
    with open(os.path.join(JAX_PKG, mod + ".py")) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and \
                not node.name.startswith("_"):
            names.add(node.name)
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            names.update(ast.literal_eval(node.value))
    return names


def _port_module(mod):
    parts = [p for p in mod.split("/") if p != "__init__"]
    return importlib.import_module(".".join(["moonbit_flate_tpu_torch", *parts]))


@pytest.mark.parametrize("mod", _jax_modules())
def test_every_public_name_has_its_port(mod):
    port = _port_module(MODULES.get(mod, mod))
    missing = []
    for name in sorted(_public_names(mod)):
        if (mod, name) in EXCLUDED:
            continue
        if (mod, name) in MOVED:
            other, port_name = MOVED[mod, name]
            found = hasattr(_port_module(other), port_name)
        else:
            found = hasattr(port, NAMES.get(name, name))
        if not found:
            missing.append(name)
    assert not missing, f"{mod}: no port of {missing}"


def test_every_exclusion_is_needed_and_has_a_reason():
    for (mod, name), reason in EXCLUDED.items():
        assert name in _public_names(mod), (mod, name)
        assert not hasattr(_port_module(MODULES.get(mod, mod)), name), (mod, name)
        assert len(reason) > 20
    for (mod, name) in MOVED:
        assert name in _public_names(mod), (mod, name)
