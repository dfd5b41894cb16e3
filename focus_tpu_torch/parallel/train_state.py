"""Train state (counterpart of ``focus_tpu/parallel/train_state.py``).

JAX keeps params and optimizer state in an immutable pytree and returns a
new one per step; here the model's parameters and the ``torch.optim`` state
are updated in place, and the state carries them with the update count and
the generator that draws the step's stochastic-depth masks.
"""


class TrainState:
    """``model`` (float32 master weights), ``optimizer``
    (``models.optimizer.Optimizer``), ``step`` (updates applied so far, a
    host int, so reading it never waits for the device) and ``generator``
    (a ``torch.Generator`` on the model's device)."""

    def __init__(self, model, optimizer, generator, step: int = 0):
        self.model = model
        self.optimizer = optimizer
        self.generator = generator
        self.step = step

    def apply_gradients(self):
        """One optimizer update from the parameters' ``.grad``, with the
        LR schedules read at the count before it; increments ``step``."""
        self.optimizer.step(self.step)
        self.step += 1
        return self
