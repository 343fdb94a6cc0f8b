"""data_ms.train: ms a step charged to the program's span `pretrain.data`
(the trainer's fetch of a batch: a sample of the device case cache or the
loader's next batch, the spatial augmentation, the layout and dtype the step
takes), beside `pretrain.step`: the device time of what it launched and the
idle time while it was open (`benchmark/spans.py`)."""
from benchmark import spans


def read(ctx):
    return spans.phase_ms(ctx, "step", "pretrain.data")
