from .topology import DesignRegion, ModeAmpWeights, TopologyObjective
