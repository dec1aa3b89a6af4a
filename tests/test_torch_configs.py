"""The port's registry against the JAX package's: every dense
architecture the JAX registry serves resolves in the port with the same
configuration, field by field."""
import dataclasses

import pytest

pytest.importorskip("torch")

from repro.configs import registry as jax_registry  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs import registry  # noqa: E402

DENSE = sorted(a for a, make in jax_registry.ARCHS.items()
               if make().family == "dense")


def test_the_jax_registry_has_the_dense_archs():
    assert {"stablelm-12b", "granite-8b", "tinyllama-1.1b",
            "qwen2-0.5b"} <= set(DENSE)


@pytest.mark.parametrize("arch", DENSE)
def test_dense_arch_equals_jax_config(arch):
    want = dataclasses.asdict(jax_registry.get_config(arch))
    got = dataclasses.asdict(get_config(arch))
    assert got == want


@pytest.mark.parametrize("arch", DENSE)
def test_dense_arch_in_the_same_table(arch):
    table = "PAPER" if arch in jax_registry.PAPER else "ASSIGNED"
    assert arch in getattr(registry, table)
