"""merge_ms.predict: ms a case charged to the program's span `predict.merge`
(the flips undone, the fp32 average and the Gaussian blend): the device time
of what it launched and the idle time while it was open
(`benchmark/spans.py`)."""
from benchmark import spans


def read(ctx):
    return spans.phase_ms(ctx, "case", "predict.merge")
