"""The LM substrate for the dense family: layers, attention, the
decoder stack and the model API (the port of ``repro.models``)."""

from repro_torch.models.model import Model, build

__all__ = ["Model", "build"]
