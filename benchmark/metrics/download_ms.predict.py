"""download_ms.predict: ms a case charged to the program's span
`predict.download` (the normalization, the logits' copy to the host, the
unpadding, the fold average): the device time of what it launched and the
idle time while it was open (`benchmark/spans.py`)."""
from benchmark import spans


def read(ctx):
    return spans.phase_ms(ctx, "case", "predict.download")
