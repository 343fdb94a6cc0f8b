"""update_ms.train: ms a step charged to the program's span `pretrain.update`
(`zero_grad`, the unread leaves' zero gradients, the all-reduce, the
division by the microbatches, the clip and AdamW): the device time of what
it launched and the idle time while it was open (`benchmark/spans.py`)."""
from benchmark import spans


def read(ctx):
    return spans.phase_ms(ctx, "step", "pretrain.update")
