"""A geometry and a preconditioner added as files alone reach the program, the
reference and the kernels' counts: throwaway modules in a folder of their
own, found by name, and no file of the harness edited."""

import copy
import textwrap

import pytest
import torch

from benchmark import system

TWIN = """
# the brick under another name
from benchmark.geometries.brick import n_dofs, program_mesh, reference_operator, small  # noqa: F401
"""

SEEDED = """
import torch

DIAGONAL = True


def _diag(n, dtype, device):
    g = torch.Generator().manual_seed(5)
    return (0.5 + torch.rand(n, generator=g, dtype=torch.float64)).to(dtype=dtype, device=device)


def program(op):
    return _diag(op.space.n_dofs, op.space.dtype, op.space.device)


def reference(ref_op, dtype):
    return _diag(ref_op.n_dofs, dtype, ref_op.device)
"""


@pytest.fixture
def added_parts(tmp_path, monkeypatch):
    """The loaders pointed at a folder that holds geometry "twin" and preconditioner "seeded"."""
    for what, folder, name, source in (("geometry", "geometries", "twin", TWIN),
                                       ("preconditioner", "preconditioners", "seeded", SEEDED)):
        (tmp_path / folder).mkdir()
        (tmp_path / folder / f"{name}.py").write_text(textwrap.dedent(source))
        monkeypatch.setitem(system.PARTS, what, tmp_path / folder)


def test_added_geometry_and_preconditioner_reach_both_sides(added_parts, tiny_cell):
    cell = tiny_cell("step64_r7_f64_cg")
    cell.config = {**copy.deepcopy(cell.config), "geometry": "twin", "preconditioner": "seeded"}
    with pytest.raises(ValueError, match="brick"):
        system.geometry("brick")  # only the added folder is looked in
    ctx = system.kernel_ctx(cell)
    assert (ctx["geometry"], ctx["preconditioner"], ctx["diag_bytes"]) == ("twin", "seeded", 8)
    assert ctx["n"] == 13**3

    data, samples, inputs, _ = system.run(cell, 1, 0.0, False, "cpu", 0.0)
    assert data.failed == 0 and samples
    # the reference's PCG with the same diagonal against the program's merged CG with it
    ref = cell.kind.reference_units(cell, inputs, [j for j, _, _ in samples], "cpu")
    for j, x, its in samples:
        x_ref, its_ref = ref[j]
        assert its == its_ref
        assert float((x - x_ref).abs().max() / x_ref.abs().max()) < 1e-10
    assert system.judge(cell, cell.kind.numbers(cell, samples, inputs, "cpu"))[1]

    # the diagonal reached the reference: without it, plain CG takes another number of iterations
    from benchmark.reference.cg import cg

    j, _, its = samples[0]
    c = cell.config["control"]
    ref_op = system.reference_operator(cell.config)
    assert cg(ref_op.apply, inputs["pool"][j], c["max_steps"], 0.0, c["reduction"])[1] != its
