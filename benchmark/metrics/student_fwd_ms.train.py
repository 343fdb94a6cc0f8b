"""student_fwd_ms.train: ms a step charged to the program's span
`pretrain.student_forward` (the student's forward and loss under the hard
mask, a microbatch each): the device time of what it launched and the idle
time while it was open (`benchmark/spans.py`)."""
from benchmark import spans


def read(ctx):
    return spans.phase_ms(ctx, "step", "pretrain.student_forward")
