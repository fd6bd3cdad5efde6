"""Parameter sweep framework: DesignSpace + sampling methods.

Behavioral model: tidy3d v2.7.6 plugins/design/ (DesignSpace:19 in
design.py, Method grid/monte-carlo/random samplers in method.py, pandas
results in result.py).
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import pydantic

from ...components.base import Tidy3dBaseModel, cached_property
from ...exceptions import SetupError
from ...log import log
from ...components.types import annotate_type


class ParameterFloat(Tidy3dBaseModel):
    """Continuous parameter with a range."""

    name: str = pydantic.Field(..., title="Name")
    span: Tuple[float, float] = pydantic.Field(..., title="(min, max)")
    num_points: Optional[int] = pydantic.Field(None, title="Grid points")

    def sample_grid(self) -> np.ndarray:
        n = self.num_points or 10
        return np.linspace(self.span[0], self.span[1], n)

    def sample_random(self, rng, num: int) -> np.ndarray:
        return rng.uniform(self.span[0], self.span[1], num)


class ParameterInt(Tidy3dBaseModel):
    """Integer parameter with an inclusive range."""

    name: str = pydantic.Field(..., title="Name")
    span: Tuple[int, int] = pydantic.Field(..., title="(min, max)")

    def sample_grid(self) -> np.ndarray:
        return np.arange(self.span[0], self.span[1] + 1)

    def sample_random(self, rng, num: int) -> np.ndarray:
        return rng.integers(self.span[0], self.span[1] + 1, num)


class ParameterAny(Tidy3dBaseModel):
    """Categorical parameter."""

    name: str = pydantic.Field(..., title="Name")
    allowed_values: Tuple[Any, ...] = pydantic.Field(..., title="Allowed values")

    def sample_grid(self) -> np.ndarray:
        return np.asarray(self.allowed_values, dtype=object)

    def sample_random(self, rng, num: int) -> np.ndarray:
        idx = rng.integers(0, len(self.allowed_values), num)
        return np.asarray(self.allowed_values, dtype=object)[idx]


ParameterType = Union[ParameterFloat, ParameterInt, ParameterAny]


class MethodGrid(Tidy3dBaseModel):
    """Full-factorial grid sampling."""

    def sample(self, parameters, rng) -> List[Dict[str, Any]]:
        grids = [p.sample_grid() for p in parameters]
        return [
            {p.name: val for p, val in zip(parameters, combo)}
            for combo in itertools.product(*grids)
        ]


class MethodMonteCarlo(Tidy3dBaseModel):
    """Latin-hypercube-ish random sampling."""

    num_points: pydantic.PositiveInt = pydantic.Field(..., title="Number of samples")

    def sample(self, parameters, rng) -> List[Dict[str, Any]]:
        samples = {p.name: p.sample_random(rng, self.num_points) for p in parameters}
        return [{name: vals[i] for name, vals in samples.items()}
                for i in range(self.num_points)]


class MethodRandom(MethodMonteCarlo):
    """Uniform random sampling."""


class MethodRandomCustom(MethodMonteCarlo):
    """Random sampling with a custom sampler (provided at run time)."""


MethodType = Union[MethodGrid, MethodMonteCarlo, MethodRandom, MethodRandomCustom]


class Result(Tidy3dBaseModel):
    """Results of a design-space sweep."""

    dims: Tuple[str, ...] = pydantic.Field((), title="Parameter names")
    values: Tuple[Any, ...] = pydantic.Field((), title="Function outputs")
    coords: Tuple[Tuple[Any, ...], ...] = pydantic.Field((), title="Parameter values")
    output_names: Optional[Tuple[str, ...]] = pydantic.Field(None)
    fn_source: Optional[str] = pydantic.Field(None)

    def to_dataframe(self):
        import pandas as pd

        records = []
        for coord, value in zip(self.coords, self.values):
            rec = dict(zip(self.dims, coord))
            if isinstance(value, dict):
                rec.update(value)
            else:
                rec["output"] = value
            records.append(rec)
        return pd.DataFrame.from_records(records)

    def sel(self, **kwargs):
        for coord, value in zip(self.coords, self.values):
            if all(coord[self.dims.index(k)] == v for k, v in kwargs.items()):
                return value
        raise KeyError(f"no result at {kwargs}")


class DesignSpace(Tidy3dBaseModel):
    """Parameter sweep: parameters x sampling method, mapped over a function."""

    parameters: Tuple[annotate_type(ParameterType), ...] = pydantic.Field(
        (), title="Parameters")
    method: annotate_type(MethodType) = pydantic.Field(..., title="Sampling method")
    task_name: str = pydantic.Field("design_sweep", title="Task name")
    folder_name: str = pydantic.Field("default", title="Folder")
    name: Optional[str] = pydantic.Field(None)

    def run(self, fn: Callable, verbose: bool = False, **kwargs) -> Result:
        """Evaluate fn(**params) for every sample point."""
        rng = np.random.default_rng(0)
        samples = self.method.sample(self.parameters, rng)
        dims = tuple(p.name for p in self.parameters)
        values = []
        coords = []
        for si, sample in enumerate(samples):
            if verbose:
                log.info(f"design point {si + 1}/{len(samples)}: {sample}")
            values.append(fn(**sample))
            coords.append(tuple(sample[d] for d in dims))
        return Result(dims=dims, values=tuple(values), coords=tuple(coords))

    def run_batch(self, fn_pre: Callable, fn_post: Callable, verbose: bool = False,
                  path_dir: str = ".", **batch_kwargs) -> Result:
        """fn_pre(**params) -> Simulation; batched run; fn_post(sim_data) -> out."""
        from ...web.container import Batch

        rng = np.random.default_rng(0)
        samples = self.method.sample(self.parameters, rng)
        dims = tuple(p.name for p in self.parameters)
        sims = {}
        for si, sample in enumerate(samples):
            sims[f"{self.task_name}_{si}"] = fn_pre(**sample)
        batch = Batch(simulations=sims, folder_name=self.folder_name,
                      verbose=verbose, **batch_kwargs)
        batch_data = batch.run(path_dir=path_dir)
        values = [fn_post(batch_data[f"{self.task_name}_{si}"])
                  for si in range(len(samples))]
        coords = [tuple(s[d] for d in dims) for s in samples]
        return Result(dims=dims, values=tuple(values), coords=tuple(coords))
