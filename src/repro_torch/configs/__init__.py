"""Configs: the ten model configs with their shape cells and registry
(``base`` and one module per arch), and the vector-engine grids
(``vector_engine``, imported on its own: it pulls in the engine)."""
from repro_torch.configs.base import (ARCH_IDS, SHAPES, InputShape,
                                      ModelConfig, get_config, iter_cells,
                                      list_configs, register,
                                      shape_applicable)
