"""Model zoo: the LM stack over the port's layers (one module per layer)."""
from repro_torch.models.model import (  # noqa: F401
    LanguageModel, init_params, model_spec, params_from_numpy)
