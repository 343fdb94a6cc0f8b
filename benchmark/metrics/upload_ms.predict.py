"""upload_ms.predict: ms a case charged to the program's span `predict.upload`
(the padding, the layout change and the volume's copy to the device, the
Gaussian and the zeroed accumulators): the device time of what it launched
and the idle time while it was open (`benchmark/spans.py`)."""
from benchmark import spans


def read(ctx):
    return spans.phase_ms(ctx, "case", "predict.upload")
