"""Host ms inside ``GANTrainer.step`` a step, over the traced run's
unprofiled part (the call returns before the card has finished)."""


def read(ctx):
    if ctx.get("steps") is None:
        return None
    return 1e3 * ctx.enqueue_s / ctx.steps
