"""forward_ms.predict: ms a case charged to the program's span
`predict.forward` (the network on each tile batch, its permutes included):
the device time of what it launched and the idle time while it was open
(`benchmark/spans.py`)."""
from benchmark import spans


def read(ctx):
    return spans.phase_ms(ctx, "case", "predict.forward")
