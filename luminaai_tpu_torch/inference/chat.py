"""Build a serving engine on a device (the port's counterpart of the JAX
package's ChatInterface loading path, inference/chat.py
load_model_for_inference).

Weights come from a training checkpoint (`checkpoint`: a checkpoints
directory or the training output directory holding one; the newest step
whose sha256 manifest verifies, with its config from the checkpoint's
metadata), from a flax parameter tree saved as an .npz of '/'-joined keys
(convert.flatten_tree; load with convert.params_from_flax), or from a seed
(convert.init_params).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional, Tuple

import numpy as np

from luminaai_tpu_torch.config import Config
from luminaai_tpu_torch.convert import (
    flax_to_state_dict,
    init_params,
    params_from_flax,
)
from luminaai_tpu_torch.data.tokenizer import ConversationTokenizer
from luminaai_tpu_torch.inference.generate import GenerationEngine
from luminaai_tpu_torch.models.transformer import LuminaTransformer

logger = logging.getLogger(__name__)


def load_checkpoint_params(
    checkpoint: str,
    config: Optional[Config] = None,
    overrides: Optional[Dict[str, Any]] = None,
    mode: str = "full",
) -> Tuple[Dict[str, Any], Config, int]:
    """(state_dict of the saved fp32 parameters on the CPU, config, step)
    of the newest intact step under `checkpoint`. The config is the one
    the checkpoint was trained with (with `overrides` applied) unless one
    is given."""
    from luminaai_tpu_torch.training.checkpoint import (
        find_checkpoint_step,
        load_state_file,
    )

    step_dir, meta = find_checkpoint_step(checkpoint, mode=mode)
    if config is None:
        config = Config.from_dict({**meta["config"], **(overrides or {})})
    tree = load_state_file(step_dir)
    logger.info("serving checkpoint %s (step %s)", step_dir, meta.get("step"))
    return flax_to_state_dict(tree["params"], config), config, meta["step"]


def build_engine(
    config: Optional[Config],
    *,
    device=None,
    seed: Optional[int] = None,
    weights: Optional[str] = None,
    checkpoint: Optional[str] = None,
    overrides: Optional[Dict[str, Any]] = None,
) -> GenerationEngine:
    """A GenerationEngine with its model on `device` (None = the card;
    raises where CUDA is absent). Weights: the checkpoint at `checkpoint`
    (config None = the checkpoint's, with `overrides` applied), else the
    .npz at `weights`, else a random init from `seed` (config.seed when
    None)."""
    state_dict = None
    if checkpoint is not None:
        state_dict, config, _ = load_checkpoint_params(
            checkpoint, config, overrides)
    model = LuminaTransformer(config, device=device)
    if state_dict is not None:
        model.load_params(state_dict)
    elif weights is not None:
        with np.load(weights) as npz:
            model.load_params(params_from_flax(dict(npz), config))
    else:
        init_params(model, config.seed if seed is None else seed)
    return GenerationEngine(
        model, ConversationTokenizer(model_name=config.tokenizer_name),
        config,
    )
