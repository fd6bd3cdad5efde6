from .design import (
    DesignSpace,
    MethodGrid,
    MethodMonteCarlo,
    MethodRandom,
    MethodRandomCustom,
    ParameterAny,
    ParameterFloat,
    ParameterInt,
    Result,
)
