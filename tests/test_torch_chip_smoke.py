"""chip_smoke.flash_taken: the route check of B1-B3 (the kernel each call
launched), with the profiler and the flash library's launch record
stubbed, since neither runs without a card."""

import pytest

import chip_smoke
from luminaai_tpu_torch.ops import flash_attention as fa

LIB = {"B1": "flash_fwd_wgmma_kernel<128, false>",
       "B2": "flash_bwd_dq_wgmma_kernel<192, false>",
       "B3": "flash_bwd_dkv_wgmma_hd256_kernel<192, true>"}
CALLS = {kern: (lambda: None) for kern in LIB}


@pytest.fixture
def stubs(monkeypatch):
    profiled = {}
    calls = iter(LIB)
    monkeypatch.setattr(chip_smoke, "kernel_names",
                        lambda fn: profiled[next(calls)])
    monkeypatch.setattr(fa, "last_kernel", LIB.__getitem__)
    monkeypatch.setattr(chip_smoke, "log", lambda msg: None)
    return profiled


def test_profiler_names_that_agree_with_the_library_stand(stubs):
    stubs.update({kern: [f"void (anonymous namespace)::{name}(CUtensorMap)"]
                  for kern, name in LIB.items()})
    assert chip_smoke.flash_taken(CALLS) == {k: [n] for k, n in LIB.items()}


def test_library_record_stands_in_where_the_profiler_records_nothing(stubs):
    stubs.update({kern: [f"void {name}(int)"] for kern, name in LIB.items()})
    stubs["B2"] = []
    taken = chip_smoke.flash_taken(CALLS)
    assert taken == {k: [n] for k, n in LIB.items()}
    chip_smoke._require_kernels(taken, "a stub", chip_smoke.flash_kernels(192)
                                | {"B1": "flash_fwd_wgmma_kernel"})


def test_profiler_and_library_that_disagree_fail(stubs):
    stubs.update({kern: [f"void {name}(int)"] for kern, name in LIB.items()})
    stubs["B2"] = ["void flash_bwd_dq_wide_kernel(int)"]
    with pytest.raises(AssertionError, match="library recorded"):
        chip_smoke.flash_taken(CALLS)
