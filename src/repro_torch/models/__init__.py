"""The model families of the port (``transformer``, ``moe``, ``ssm``,
``hybrid``, ``encdec``, ``vlm``) behind one API (``api``), and their shared
layers."""
from repro_torch.models.api import Model, batch_logical, build, input_specs
