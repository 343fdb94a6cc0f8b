"""hard_mask_ms.train: ms a step charged to the program's span
`pretrain.hard_mask` (`generate_guided_mask` from the teacher's per-patch
loss, a microbatch each): the device time of what it launched and the idle
time while it was open (`benchmark/spans.py`)."""
from benchmark import spans


def read(ctx):
    return spans.phase_ms(ctx, "step", "pretrain.hard_mask")
