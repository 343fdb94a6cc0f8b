"""tiles_ms.predict: ms a case charged to the program's span `predict.tiles`
(the tile batches cut from the volume and their flips stacked): the device
time of what it launched and the idle time while it was open
(`benchmark/spans.py`)."""
from benchmark import spans


def read(ctx):
    return spans.phase_ms(ctx, "case", "predict.tiles")
