"""The optimizer's host offload on the card (marked `cuda`; skips without
one): between steps every moment lives in pinned host memory, and three
steps give the parameters and moments of the moments kept on the card,
bitwise, for the fp32, bf16-mu and int8 forms. chip_smoke.py phase 16
(b) runs the same check at the flagship widths. This file imports
nothing of JAX:

    python -m pytest tests/test_torch_cuda_offload.py -q --noconftest
"""

import numpy as np
import pytest
import torch

from luminaai_tpu_torch.config import Config
from luminaai_tpu_torch.convert import init_params
from luminaai_tpu_torch.models.transformer import LuminaTransformer
from luminaai_tpu_torch.parallel import train_step as ts
from luminaai_tpu_torch.training.optimizer import (
    make_optimizer,
    make_schedule,
)

pytestmark = pytest.mark.cuda

ARCH = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
            num_kv_heads=2, seq_length=128, intermediate_size=256,
            batch_size=4, precision="bf16", use_moe=True, num_experts=4,
            moe_pattern="all", learning_rate=1e-2, routing_noise_std=0.0,
            use_flash_attention=False)
FORMS = {"fp32": {}, "bf16": dict(adam_mu_dtype="bf16"),
         "int8": dict(adam_state_quantization="int8")}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: pinned host memory and the "
                    "copy stream exist only there")
    return torch.device("cuda")


def _run(dev, form: str, offload: bool):
    cfg = Config(**ARCH, **FORMS[form], host_offload_optimizer=offload)
    model = init_params(LuminaTransformer(cfg, device=dev, trainable=True),
                        0)
    sched = make_schedule(cfg, 5)
    tx = make_optimizer(cfg, 5, sched)
    state = ts.init_train_state(model, tx, 0)
    step = ts.make_train_step(cfg, model, sched, tx)
    rng = np.random.RandomState(0)
    where = []
    for _ in range(3):
        ids = torch.as_tensor(rng.randint(1, 512, (4, 128))).to(dev)
        state, _ = step(state, {"input_ids": ids})
        where.append({(t.device.type, t.is_pinned())
                      for t in state.opt_state.tensors()})
    torch.cuda.synchronize()
    return ([p.detach().cpu() for p in state.params],
            [t.detach().cpu() for t in state.opt_state.tensors()], where)


@pytest.mark.parametrize("form", sorted(FORMS))
def test_offloaded_moments_are_pinned_and_bitwise(dev, form):
    p_card, m_card, where_card = _run(dev, form, False)
    p_host, m_host, where_host = _run(dev, form, True)
    assert all(w == {("cuda", False)} for w in where_card), where_card
    assert all(w == {("cpu", True)} for w in where_host), where_host
    for a, b in zip(p_card + m_card, p_host + m_host):
        assert torch.equal(a, b)
