"""String-keyed plugin registries.

Equivalent of the reference's `SvarWithType<funcCreate*>` plugin seams
(SURVEY.md section 1: Tracker/Mapper/Matcher/Initializer/FeatureDetector/Map/
LoopDetector/Estimator/Optimizer/Dataset registries). Config selects
implementations by name, e.g. `Tracker?=opt`, `Matcher?=multiH`.
"""
from __future__ import annotations

from typing import Callable, Dict


class Registry:
    def __init__(self, kind: str):
        self.kind = kind
        self._creators: Dict[str, Callable] = {}

    def register(self, name: str, creator: Callable | None = None):
        """Use as a decorator `@registry.register("name")` or directly."""
        if creator is not None:
            self._creators[name] = creator
            return creator

        def deco(fn):
            self._creators[name] = fn
            return fn
        return deco

    def create(self, name: str, *args, **kwargs):
        if name not in self._creators:
            raise KeyError(
                f"no {self.kind} named {name!r}; have {sorted(self._creators)}")
        return self._creators[name](*args, **kwargs)

    def names(self):
        return sorted(self._creators)

    def __contains__(self, name):
        return name in self._creators


# the framework's plugin seams (mirrors the reference registry inventory)
TRACKERS = Registry("Tracker")
MAPPERS = Registry("Mapper")
MATCHERS = Registry("Matcher")
INITIALIZERS = Registry("Initializer")
FEATURE_DETECTORS = Registry("FeatureDetector")
MAPS = Registry("Map")
LOOP_DETECTORS = Registry("LoopDetector")
LOOP_CLOSERS = Registry("LoopCloser")
RELOCALIZERS = Registry("Relocalizer")
ESTIMATORS = Registry("Estimator")
OPTIMIZERS = Registry("Optimizer")
DATASETS = Registry("Dataset")   # keyed by file extension
MAP2DS = Registry("Map2D")       # keyed by Map2D.Type
