from .registry import (  # noqa: F401
    ARCH_IDS,
    SHAPES,
    SUBQUADRATIC,
    ShapeSpec,
    all_cells,
    get_config,
    input_specs,
    shape_applicable,
)
