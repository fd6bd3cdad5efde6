"""The heat solver of the port against the JAX package's.

``components/heat/`` is a copy of the JAX package's (scipy ``spsolve`` on
the host; neither package runs device code here). Each of the five cases
of ``tests/test_components/test_heat.py`` is built in the port, carried to
the JAX package through its JSON (``HeatSimulation.parse_raw``) and run in
both: every monitor's temperature equal within ``TOL`` relative (the
structured arrays and the unstructured datasets' points, cells and
values), and the case's own physics check on the port's data.
"""

import numpy as np
import pytest

# first: where h5py is missing it makes the JAX package importable
import tests.torch_cases  # noqa: F401
import tidy3d_tpu
import tidy3d_tpu_torch as td
from tidy3d_tpu_torch.components.data.unstructured import (
    TetrahedralGridDataset, TriangularGridDataset,
)

TOL = 1e-9      # relative, of the largest temperature


def _solid(k, cap=1.0, name=None):
    return td.Medium(heat_spec=td.SolidSpec(conductivity=k, capacity=cap),
                     name=name)


def _pinned(hot="hot", cold="cold", t_hot=400.0, t_cold=300.0):
    return [td.HeatBoundarySpec(
                condition=td.TemperatureBC(temperature=t_hot),
                placement=td.StructureBoundary(structure=hot)),
            td.HeatBoundarySpec(
                condition=td.TemperatureBC(temperature=t_cold),
                placement=td.StructureBoundary(structure=cold))]


def _plates_and_slab(monitors):
    plate_l = td.Structure(geometry=td.Box(center=(-4.5, 0, 0),
                                           size=(1, 10, 10)),
                           medium=_solid(100.0), name="hot")
    plate_r = td.Structure(geometry=td.Box(center=(4.5, 0, 0),
                                           size=(1, 10, 10)),
                           medium=_solid(100.0), name="cold")
    slab = td.Structure(geometry=td.Box(center=(0, 0, 0), size=(8, 10, 10)),
                        medium=_solid(1.3), name="slab")
    return td.HeatSimulation(
        center=(0, 0, 0), size=(10, 10, 10), medium=_solid(1.3),
        structures=[slab, plate_l, plate_r], boundary_spec=_pinned(),
        monitors=monitors, grid_spec=td.GridSpec.uniform(dl=0.5))


def linear_profile():
    return _plates_and_slab([td.TemperatureMonitor(
        center=(0, 0, 0), size=(8, 0, 0), name="line")])


def _heated(size, boundary, monitor, k, rate):
    heater = td.Structure(
        geometry=td.Box(center=(0, 0, 0), size=(td.inf, td.inf, td.inf)),
        medium=_solid(k), name="heater")
    return td.HeatSimulation(
        center=(0, 0, 0), size=size, medium=_solid(k), structures=[heater],
        sources=[td.UniformHeatSource(structures=["heater"], rate=rate)],
        boundary_spec=[td.HeatBoundarySpec(
            condition=boundary, placement=td.SimulationBoundary())],
        monitors=[monitor], grid_spec=td.GridSpec.uniform(dl=0.25))


def volumetric_source():
    return _heated((8.0, 4, 4), td.TemperatureBC(temperature=300.0),
                   td.TemperatureMonitor(center=(0, 0, 0), size=(8.0, 0, 0),
                                         name="line"), 2.0, 5.0)


def two_layer_series():
    return two_layer_stack(dl=0.25)


def two_layer_stack(dl=0.25, width=4.0):
    """Two slabs in series between pinned plates (k 1 and 4, 4.5 um each
    along x, ``width`` across), a point monitor at the interface."""
    def box(x, sx, k, name):
        return td.Structure(geometry=td.Box(center=(x, 0, 0),
                                            size=(sx, width, width)),
                            medium=_solid(k), name=name)
    return td.HeatSimulation(
        center=(0, 0, 0), size=(10, width, width), medium=_solid(1.0),
        structures=[box(-2.25, 4.5, 1.0, "left"), box(2.25, 4.5, 4.0, "right"),
                    box(-4.75, 0.5, 500.0, "hot"),
                    box(4.75, 0.5, 500.0, "cold")],
        boundary_spec=_pinned(),
        monitors=[td.TemperatureMonitor(center=(0, 0, 0), size=(0, 0, 0),
                                        name="mid")],
        grid_spec=td.GridSpec.uniform(dl=dl))


def series_theory(t_hot=400.0, t_cold=300.0, k1=1.0, k2=4.0):
    """The interface temperature of two 4.5 um layers in series."""
    r1, r2 = 4.5 / k1, 4.5 / k2
    return t_hot + (t_cold - t_hot) * r1 / (r1 + r2)


def convection():
    return _heated((4, 4, 4), td.ConvectionBC(ambient_temperature=300.0,
                                              transfer_coeff=2.0),
                   td.TemperatureMonitor(center=(0, 0, 0), size=(4, 4, 4),
                                         name="vol"), 10.0, 3.0)


def unstructured():
    return _plates_and_slab([
        td.TemperatureMonitor(center=(0, 0, 0), size=(8, 4, 0),
                              name="plane", unstructured=True),
        td.TemperatureMonitor(center=(0, 0, 0), size=(8, 4, 4),
                              name="vol", unstructured=True),
        td.TemperatureMonitor(center=(0, 0, 0), size=(8, 4, 4),
                              name="vol_struct")])


CASES = {f.__name__: f for f in (linear_profile, volumetric_source,
                                 two_layer_series, convection, unstructured)}


def _arrays(temp) -> dict:
    """A monitor's temperature as named numpy arrays."""
    if isinstance(temp, (TriangularGridDataset, TetrahedralGridDataset)) \
            or hasattr(temp, "cells"):
        return {"points": np.asarray(temp.points.values),
                "cells": np.asarray(temp.cells.values),
                "values": np.asarray(temp.values.values)}
    out = {"values": np.asarray(temp.values)}
    out.update({f"coord {d}": np.asarray(temp.coords[d]) for d in "xyz"})
    return out


def to_reference(sim):
    """The JAX package's ``HeatSimulation`` equal to the port's ``sim``.
    ``Medium.heat_spec`` is typed ``Any`` in both packages, so a parsed one
    stays a dict (and the solver would read no conductivity, the same gap
    as ``modulation_spec``, ``tests/torch_cases.to_reference``): each is
    rebuilt as the reference's ``SolidSpec`` or ``FluidSpec``."""
    ref = tidy3d_tpu.HeatSimulation.parse_raw(sim.json())

    def medium(m):
        spec = m.heat_spec
        if not isinstance(spec, dict):
            return m
        cls = getattr(tidy3d_tpu, spec["type"])
        return m.copy(update=dict(heat_spec=cls.parse_obj(spec)))

    return ref.copy(update=dict(
        medium=medium(ref.medium),
        structures=[st.copy(update=dict(medium=medium(st.medium)))
                    for st in ref.structures]))


def test_parsed_heat_specs_are_dicts_in_both_packages():
    """The gap ``to_reference`` mends is the reference's own: both
    packages keep a parsed ``heat_spec`` as a dict."""
    sim = convection()
    for pkg in (td, tidy3d_tpu):
        parsed = pkg.HeatSimulation.parse_raw(sim.json())
        assert isinstance(parsed.medium.heat_spec, dict)
    assert isinstance(to_reference(sim).medium.heat_spec, tidy3d_tpu.SolidSpec)


@pytest.mark.parametrize("case", sorted(CASES))
def test_heat_matches_the_reference(case):
    sim = CASES[case]()
    ref_sim = to_reference(sim)
    assert type(ref_sim).__module__.startswith("tidy3d_tpu.")
    got, want = sim.run(), ref_sim.run()
    names = [m.name for m in sim.monitors]
    scale = max(float(np.max(np.abs(_arrays(want[n].temperature)["values"])))
                for n in names)
    assert scale > 0
    for name in names:
        a, b = _arrays(got[name].temperature), _arrays(want[name].temperature)
        assert a.keys() == b.keys()
        assert type(got[name].temperature).__name__ == \
            type(want[name].temperature).__name__
        for key in a:
            assert a[key].shape == b[key].shape, (name, key)
            if key == "cells":
                assert np.array_equal(a[key], b[key]), name
                continue
            ref_scale = scale if key == "values" else 1.0
            err = float(np.max(np.abs(a[key] - b[key]))) / ref_scale
            assert err <= TOL, (name, key, err)
    if case == "two_layer_series":
        t_mid = float(np.asarray(got["mid"].temperature.values).squeeze())
        assert abs(t_mid - series_theory()) < 2.0
    if case == "unstructured":
        assert isinstance(got["plane"].temperature, TriangularGridDataset)
        assert isinstance(got["vol"].temperature, TetrahedralGridDataset)
