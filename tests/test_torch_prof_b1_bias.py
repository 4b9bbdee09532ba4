"""``prof_b1_bias.py`` builds its variants of the covariance kernels' radial
profile by patching the text of ``csrc/stationary_family.cuh`` and
``csrc/stationary_k_kernels.cuh``. Every variant's patch must still match the
sources as they stand (the script stops with an ``AssertionError`` where one
does not); this checks the texts without ``nvcc``."""
import pytest

from gaussian_process_optimization_tpu_torch import prof_b1_bias
from gaussian_process_optimization_tpu_torch.ops import _build
from torch_threads import one_torch_thread  # noqa: F401

HEADER = (_build.SRC_DIR / "stationary_family.cuh").read_text()
KERNELS = (_build.SRC_DIR / "stationary_k_kernels.cuh").read_text()
SOURCES = prof_b1_bias.variant_sources(HEADER, KERNELS)


def test_every_variant_patches_and_differs():
    assert list(SOURCES) == list(prof_b1_bias.VARIANTS)
    assert SOURCES["as is"] == (HEADER, KERNELS)
    texts = {h + k for h, k in SOURCES.values()}
    assert len(texts) == len(SOURCES)


@pytest.mark.parametrize("name", [n for n in prof_b1_bias.VARIANTS if n != "as is"])
def test_variant_text(name):
    """Each variant holds the forms it names and no longer the ones it
    replaces: before C9 is ex2.approx of the pre-scaled argument with
    ratquad's lg2.approx, as the profile was."""
    header, kernels = SOURCES[name]
    changes = prof_b1_bias.VARIANTS[name]
    prescaled = "ex2_approx((-kSqrt5 * kLog2e) * r)"
    if "prescaled" in changes:
        assert prescaled in header and "exp_nat(-kSqrt5 * r)" not in header
    if "lg2" in changes:
        assert "lg2_approx(base)" in header and "log2f(base)" not in header
    if "exp2f" in changes:
        assert "y = exp2f(x);" in header and 'asm("ex2.approx' not in header
    if "sqrtf" in changes:
        assert "y = sqrtf(x);" in header and 'asm("sqrt.approx' not in header
    if "expf" in changes:
        assert "return expf(x);" in header and "fmaf(y, e * kLn2, y)" not in header
    if "backward before" in changes:
        assert header.count(prescaled) == 1 and "void profile_before(" in header
        assert kernels.count("profile_before<FAMILY>(") == 2
        assert kernels.count(prof_b1_bias._FORWARD_CALL) == 1
    else:
        assert kernels == KERNELS
