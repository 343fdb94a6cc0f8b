"""load_weights_ms.predict: ms a case charged to the program's span
`predict.load_weights` (each fold's weights loaded into the network): the
device time of what it launched and the idle time while it was open
(`benchmark/spans.py`)."""
from benchmark import spans


def read(ctx):
    return spans.phase_ms(ctx, "case", "predict.load_weights")
