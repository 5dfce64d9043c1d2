"""The LM substrate: layers, attention, the decoder stack of any block
pattern (MoE, Mamba, xLSTM mixers), the encoder-decoder, the stub
frontends and the model API (the port of ``repro.models``)."""

from repro_torch.models.model import Model, build

__all__ = ["Model", "build"]
