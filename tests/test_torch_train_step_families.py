"""One ``train_step`` of the four slowest reduced families (MLA + MoE,
SSD, RG-LRU, the encoder-decoder) in f32 and in bf16 against the
reference, with ``tests/test_torch_train_step.py``'s helpers and bounds
(see its docstring); a file of their own so that ``--dist loadfile``
puts them on another worker than the other six."""
import pytest

pytest.importorskip("torch")

from test_torch_train_step import HEAVY, bf16_case, f32_case  # noqa: E402


@pytest.mark.parametrize("name", HEAVY)
def test_train_step_f32_matches_reference(name):
    f32_case(name)


@pytest.mark.parametrize("name", HEAVY)
def test_train_step_bf16(name):
    bf16_case(name)
