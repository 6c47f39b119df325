"""The port's cell matrix (`repro_torch.launch.cells`) against the
reference's (`repro.launch.cells`): the shapes, the skips and their
reasons, and every input stand-in's leaf names, shapes and dtypes against
the reference's ``jax.eval_shape`` trees, at smoke size for every
applicable cell and at full size for granite-3-8b and mixtral-8x7b.
Nothing is allocated on either side."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.launch import cells as RC  # noqa: E402
from repro_torch.launch import cells as PC  # noqa: E402
from repro_torch.train.tree import leaves_with_paths  # noqa: E402

FULL_ARCHS = ("granite-3-8b", "mixtral-8x7b")


def test_shapes_and_subquadratic_equal_the_reference():
    assert {k: dataclasses.asdict(v) for k, v in PC.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in RC.SHAPES.items()}
    assert PC.SUBQUADRATIC == RC.SUBQUADRATIC


def test_cell_applicable_and_all_cells_equal_the_reference():
    """The reference's architectures' cells are the reference's; the
    port-only architectures' cells are all inapplicable."""
    ref_archs = {arch for arch, _, _, _ in RC.all_cells()}
    assert [c for c in PC.all_cells() if c[0] in ref_archs] == RC.all_cells()
    own = [c for c in PC.all_cells() if c[0] not in ref_archs]
    assert own and not any(ok for _, _, ok, _ in own)
    for arch, sname, _, _ in RC.all_cells():
        assert PC.cell_applicable(arch, sname) == RC.cell_applicable(
            arch, sname)


def _ref_leaves(tree) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        key = tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
        out[key] = (tuple(leaf.shape), jnp.dtype(leaf.dtype).name)
    return out


def _port_leaves(tree) -> dict:
    return {path: (s.shape, str(s.dtype).removeprefix("torch."))
            for path, s in leaves_with_paths(tree)}


_CELLS = [(arch, sname, True) for arch, sname, ok, _ in RC.all_cells()
          if ok] + [(arch, sname, False) for arch, sname, ok, _
                    in RC.all_cells() if ok and arch in FULL_ARCHS]


@pytest.mark.parametrize(
    "arch,shape_name,smoke", _CELLS,
    ids=[f"{a}-{s}-{'smoke' if sm else 'full'}" for a, s, sm in _CELLS])
def test_input_specs_leaves_equal_the_reference(arch, shape_name, smoke):
    ref = RC.input_specs(arch, shape_name, smoke=smoke)
    port = PC.input_specs(arch, shape_name, smoke=smoke)
    assert len(port) == len(ref)
    for r, p in zip(ref, port):
        assert _port_leaves(p) == _ref_leaves(r)


def test_input_specs_allocate_nothing():
    # the full granite-3-8b train cell: 8.17 B parameters and their
    # moments as stand-ins only
    params, opt_state, batch, step = PC.input_specs("granite-3-8b",
                                                    "train_4k")
    n = sum(s.nbytes for _, s in leaves_with_paths(params))
    assert n == 4 * PC.get_config("granite-3-8b").param_count()
    assert all(isinstance(s, PC.ShapeDtypeStruct)
               for tree in (params, opt_state, batch)
               for _, s in leaves_with_paths(tree))
    assert step == PC.ShapeDtypeStruct((), torch.int32)
