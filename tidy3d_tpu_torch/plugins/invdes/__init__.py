from .region import TopologyDesignRegion
from .design import InverseDesign
from .optimizer import AdamOptimizer, OptimizeResult
