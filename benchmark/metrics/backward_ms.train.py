"""backward_ms.train: ms a step charged to the program's span
`pretrain.backward` (`loss.backward()`: dx, dw and, under remat, the
recomputed forwards, a microbatch each): the device time of what it launched
and the idle time while it was open (`benchmark/spans.py`)."""
from benchmark import spans


def read(ctx):
    return spans.phase_ms(ctx, "step", "pretrain.backward")
