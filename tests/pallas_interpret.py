"""Run jax's Pallas TPU flash attention in interpret mode on the CPU without
its eager-mode deadlock.

Executed op by op (outside jit), an interpreted `pallas_call` runs its
kernel through io_callbacks on a runtime thread, and those callbacks
dispatch JAX ops of their own (they iterate device arrays). With async
dispatch the test's thread goes on dispatching the next op meanwhile, and
the two dispatches were seen to deadlock now and then (every thread idle,
the test stuck in `jax.grad`). Waiting for each flash `pallas_call`'s
outputs before going on keeps the two apart; the arithmetic is unchanged.
"""

import contextlib
import types

import jax


class _SyncedPallas(types.ModuleType):
    """`jax.experimental.pallas` whose `pallas_call` waits for its outputs."""

    def __init__(self, pl):
        super().__init__(pl.__name__)
        self._pl = pl

    def __getattr__(self, name):
        return getattr(self._pl, name)

    def pallas_call(self, *args, **kwargs):
        call = self._pl.pallas_call(*args, **kwargs)

        def synced(*operands):
            return jax.block_until_ready(call(*operands))

        return synced


@contextlib.contextmanager
def synced_flash_interpret_mode(monkeypatch):
    """`pltpu.force_tpu_interpret_mode()` for jax's flash attention, each
    of its `pallas_call`s waited for."""
    import jax.experimental.pallas.ops.tpu.flash_attention as flash
    import jax.experimental.pallas.tpu as pltpu

    monkeypatch.setattr(flash, "pl", _SyncedPallas(flash.pl))
    with pltpu.force_tpu_interpret_mode():
        yield
