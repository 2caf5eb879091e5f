"""Build a serving engine on a device (the port's counterpart of the JAX
package's ChatInterface loading path).

There is no checkpoint loader in this slice: weights come from a seed
(convert.init_params) or from a flax parameter tree saved as an .npz of
'/'-joined keys (convert.flatten_tree; load with convert.params_from_flax).
Loading orbax checkpoints waits for the training-runtime slice.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from luminaai_tpu_torch.config import Config
from luminaai_tpu_torch.convert import init_params, params_from_flax
from luminaai_tpu_torch.data.tokenizer import ConversationTokenizer
from luminaai_tpu_torch.inference.generate import GenerationEngine
from luminaai_tpu_torch.models.transformer import LuminaTransformer


def build_engine(
    config: Config,
    *,
    device=None,
    seed: Optional[int] = None,
    weights: Optional[str] = None,
) -> GenerationEngine:
    """A GenerationEngine with its model on `device` (None = the card;
    raises where CUDA is absent). Weights: the .npz at `weights`, else a
    random init from `seed` (config.seed when None)."""
    model = LuminaTransformer(config, device=device)
    if weights is not None:
        with np.load(weights) as npz:
            model.load_params(params_from_flax(dict(npz), config))
    else:
        init_params(model, config.seed if seed is None else seed)
    return GenerationEngine(model, ConversationTokenizer(), config)
