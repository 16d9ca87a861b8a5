"""The dry run's arithmetic against the JAX package's, on the CPU:
``launch/analytic.analytic_bytes_per_device`` equal (``==``) to the
reference's on every arch x shape on the production meshes' shapes
(stand-ins with ``shape``, ``axis_names`` and ``size``: no device, no
process group), ``RooflineReport``'s derived properties equal to the
reference's formulas with the TPU rates swapped for the H100's, the
useful FLOPs of each cell equal to the reference's, and the cell matrix
rebuilt from the reference's archs, shapes and skip rule.

The reference's ``launch/dryrun`` and ``launch/dryrun_pipeline`` are
not imported: importing either appends a 512-device flag to
``XLA_FLAGS``, which every later JAX test of the worker would see.
"""
import dataclasses
import math
import pathlib

import pytest

from repro.models import RunFlags as JRunFlags   # noqa: F401 (import order)
from repro.configs import ARCHS as JARCHS
from repro.configs import get_config as jget_config
from repro.launch import analytic as janalytic
from repro.launch import hloanalysis
from repro.launch import steps as jsteps
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import analytic, dryrun, traceanalysis
from repro_torch.launch.steps import SHAPES
from repro_torch.models import RunFlags


class MeshShape:
    """A mesh's ``shape``, ``axis_names`` and ``size``: all the analytic
    floor and ``partition_spec`` read."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.size = math.prod(self.shape.values())


MESHES = {"single": MeshShape({"data": 16, "model": 16}),
          "multi": MeshShape({"pod": 2, "data": 16, "model": 16})}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_bytes_equal_the_reference(arch, mesh):
    """Every entry of the floor, on every shape of the matrix (applicable
    or not), bf16 caches and remat "full" as the reference's dry run."""
    assert sorted(ARCHS) == sorted(JARCHS)
    m = MESHES[mesh]
    for name, shape in SHAPES.items():
        want = janalytic.analytic_bytes_per_device(
            jget_config(arch), jsteps.SHAPES[name], m)
        got = analytic.analytic_bytes_per_device(get_config(arch), shape, m)
        assert got == want, (arch, name, mesh)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("case", ["int8-cache", "no-remat"])
def test_analytic_bytes_int8_cache_and_no_remat(case, mesh):
    m = MESHES[mesh]
    kw = {"remat": "none"} if case == "no-remat" else {}
    cache = "int8" if case == "int8-cache" else "bf16"
    for arch in ARCHS:
        for name, shape in SHAPES.items():
            want = janalytic.analytic_bytes_per_device(
                jget_config(arch), jsteps.SHAPES[name], m,
                flags=JRunFlags(cache_dtype=cache), **kw)
            got = analytic.analytic_bytes_per_device(
                get_config(arch), shape, m,
                flags=RunFlags(cache_dtype=cache), **kw)
            assert got == want, (arch, name, mesh, case)


FIELDS = dict(arch="a", shape="train_4k", mesh="single", n_devices=256,
              flops_per_device=3.1e14, bytes_per_device=7.7e11,
              collective_bytes_per_device=2.9e10,
              collective_detail={"all-gather": 2.9e10},
              collective_counts={"all-gather": 14}, argument_bytes=10,
              output_bytes=7, temp_bytes=40, alias_bytes=6,
              model_flops_global=4.0e16)


@pytest.mark.parametrize("scale", [1.0, 1e-3, 1e3])
def test_roofline_report_is_the_reference_s_with_h100_rates(scale):
    """The same fields and derived properties; each time term the
    reference's times the ratio of the two rates, the rate-free ones
    equal."""
    fields = dict(FIELDS, flops_per_device=FIELDS["flops_per_device"]
                  * scale)
    got = traceanalysis.RooflineReport(**fields)
    want = hloanalysis.RooflineReport(**fields)
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    assert got.to_dict().keys() == want.to_dict().keys()
    tpu = (hloanalysis.PEAK_FLOPS, hloanalysis.HBM_BW, hloanalysis.LINK_BW)
    gpu = (traceanalysis.PEAK_FLOPS, traceanalysis.HBM_BW,
           traceanalysis.LINK_BW)
    assert gpu == (989e12, 3.35e12, 50e9)
    for term, t, g in zip(("compute_s", "memory_s", "collective_s"), tpu,
                          gpu):
        assert getattr(got, term) == pytest.approx(
            getattr(want, term) * t / g, rel=1e-15)
    terms = {"compute": got.compute_s, "memory": got.memory_s,
             "collective": got.collective_s}
    assert got.dominant == max(terms, key=terms.get)
    assert got.bound_s == max(terms.values())
    assert got.useful_flops_ratio == want.useful_flops_ratio
    assert got.roofline_fraction == pytest.approx(
        fields["model_flops_global"] / (256 * gpu[0]) / got.bound_s,
        rel=1e-15)
    assert got.peak_device_bytes == want.peak_device_bytes == 51
    assert traceanalysis.COLLECTIVE_OPS == hloanalysis._COLLECTIVE_OPS


def test_no_tpu_rate_in_the_dry_run():
    """The reference's TPU rates appear nowhere in the port's launchers
    and kernels (``core/power_model.py`` keeps the paper's TPU v5e power
    profile, a fleet catalog entry, not a rate of the dry run)."""
    src = pathlib.Path(traceanalysis.__file__).resolve().parents[1]
    for path in [*(src / "launch").rglob("*.py"),
                 *(src / "kernels").rglob("*.py")]:
        text = path.read_text()
        for rate in ("197e12", "819e9", "197 TFLOP", "819 GB"):
            assert rate not in text, (path, rate)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_global_equal_the_reference_s(arch):
    """``run_cell``'s useful FLOPs: 6 (train) or 2 N_active a token, over
    the tokens of each shape."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    for name, shape in SHAPES.items():
        tokens = shape.global_batch * (1 if shape.kind == "decode"
                                       else shape.seq_len)
        train = shape.kind == "train"
        assert cfg.model_flops_per_token(train=train) * tokens == \
            jcfg.model_flops_per_token(train=train) * tokens


def test_cell_matrix_is_the_reference_s():
    """Rebuilt as the reference's ``dryrun.py`` builds it, from its
    archs, shapes and skip rule (its module is not imported)."""
    want = [(arch, name, *jsteps.shape_applicable(jget_config(arch), shape))
            for arch in [a for a in JARCHS if a != "qwen2-5-7b"]
            for name, shape in jsteps.SHAPES.items()]
    assert list(dryrun.cell_matrix()) == want
    assert dryrun.ASSIGNED == [a for a in JARCHS if a != "qwen2-5-7b"]
    assert sum(ok for *_, ok, _ in want) == 34
