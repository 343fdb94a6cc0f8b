"""anatomask_torch.ops.norm_act, the moments' bias, and the models' one-pass
norm epilogue on the CPU: the plain version against the op sequence it
replaces, bit for bit in bf16 and fp32 in every mode; the moments of a biased
tensor taken with the bias; STUNet, PlainConvUNet (instance and batch norms)
and the LightDecoder under no_grad against the same forward under autograd,
bit for bit, with the pass taken once a norm; gradients under autograd
unchanged; the wrapper's checks; and the kernel's name in the benchmark's
kernel groups. The `card` tests hold the CUDA kernel to its plain version at
the volume's shapes and count its launches in a STUNet-B tile forward; they
skip without a CUDA device (on the card: `python -m pytest --noconftest -m card
tests/test_torch_norm_act.py`)."""
from pathlib import Path

import pytest
import torch
import torch.nn.functional as fn

from anatomask_torch.models import layers
from anatomask_torch.models.layers import CL3D, ConvND, InstanceNorm
from anatomask_torch.models.plain_unet import PlainConvUNet
from anatomask_torch.models.stunet import BasicResBlock, STUNet
from anatomask_torch.ops import _build
from anatomask_torch.ops.moments import row_moments_forward
from anatomask_torch.ops.norm_act import norm_act, norm_act_plain
from anatomask_torch.ssl.decoder import LightDecoder
from benchmark.trace import kernel_group

CSRC = Path(__file__).resolve().parents[1] / "anatomask_torch" / "csrc"
DTYPES = (torch.bfloat16, torch.float32)


def bits(t):
    """A tensor's bit pattern, for equality that tells -0 from 0 and NaNs apart."""
    return t.contiguous().view(torch.int16 if t.element_size() == 2 else torch.int32)


def assert_same_bits(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(bits(got), bits(want))


def operands(shape, dtype, rows, seed):
    """NDHWC y and skip in dtype, fp32 (rows, C) a and b and (C,) biases."""
    g = torch.Generator().manual_seed(seed)
    B, C = shape[0], shape[-1]
    y = (torch.randn(shape, generator=g) * 3).to(dtype)
    skip = torch.randn(shape, generator=g).to(dtype)
    a = torch.rand((rows, C), generator=g) * 2 + 0.1
    b = torch.randn((rows, C), generator=g)
    bias, skip_bias = torch.randn(C, generator=g), torch.randn(C, generator=g)
    return y, a, b, bias, skip, skip_bias


def op_sequence(y, a, b, bias, act, skip, skip_bias):
    """The model's unfused norm epilogue as it reads in NCDHW: the conv's
    bias add, the norm's x * a + b, the skip conv's bias add, the residual
    add, leaky_relu (models/layers.py, models/stunet.py)."""
    dt = y.dtype
    col = (1, -1, 1, 1, 1)
    y = y.permute(0, 4, 1, 2, 3)
    if bias is not None:
        y = y + bias.to(dt).view(col)
    out = y * a.to(dt)[:, :, None, None, None] + b.to(dt)[:, :, None, None, None]
    if skip is not None:
        skip = skip.permute(0, 4, 1, 2, 3)
        if skip_bias is not None:
            skip = skip + skip_bias.to(dt).view(col)
        out = out + skip
    if act:
        out = fn.leaky_relu(out, 0.01)
    return out.permute(0, 2, 3, 4, 1)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("act", [False, True])
@pytest.mark.parametrize("skip_mode", ["none", "skip", "skip_bias"])
@pytest.mark.parametrize("rows", ["batch", "one"])
def test_plain_equals_the_op_sequence(dtype, with_bias, act, skip_mode, rows):
    shape = (2, 5, 4, 3, 24)
    y, a, b, bias, skip, skip_bias = operands(shape, dtype, 2 if rows == "batch" else 1,
                                              seed=len(skip_mode) + 7 * act)
    bias = bias if with_bias else None
    skip = None if skip_mode == "none" else skip
    skip_bias = skip_bias if skip_mode == "skip_bias" else None
    got = norm_act(y, a, b, bias, act, skip, skip_bias)
    assert_same_bits(got, op_sequence(y, a, b, bias, act, skip, skip_bias).contiguous())
    assert_same_bits(norm_act_plain(y, a, b, bias, act, skip, skip_bias), got)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("square_in_dtype", [False, True])
def test_moments_with_a_bias_equal_moments_of_the_biased_tensor(dtype, masked,
                                                                square_in_dtype):
    y, _, _, bias, _, _ = operands((2, 6, 5, 4, 16), dtype, 1, seed=3)
    mask = torch.rand(y.shape[:4], generator=torch.Generator().manual_seed(4)) > 0.3
    mask = mask if masked else None
    got = row_moments_forward(y, mask, square_in_dtype, bias=bias)
    want = row_moments_forward(y + bias.to(dtype), mask, square_in_dtype)
    for g, w in zip(got, want):
        assert_same_bits(g, w)


def randomize(net, seed):
    """Every parameter drawn at random, so that conv biases and norm affines
    are not the zeros and ones a fresh network has."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith("weight") and p.dim() > 1:
                continue  # the convs keep their He init
            base = 1.0 if name.endswith("weight") else 0.0
            p.copy_(base + 0.3 * torch.randn(p.shape, generator=g))
    return net


@pytest.fixture
def count_passes(monkeypatch):
    """Counts the models' calls of ops/norm_act.py (a CPU run launches no kernel)."""
    calls = []

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return norm_act(*args, **kw)

    monkeypatch.setattr(layers, "norm_act", counted)
    return calls


def tiny_stunet(dtype):
    # 3 stages, a two-block stage (its second block's skip is the identity)
    net = STUNet(1, 3, depth=(1, 2, 1), dims=(8, 16, 16), pool_op_kernel_sizes=[(2, 2, 2)] * 2,
                 dtype=dtype, generator=torch.Generator().manual_seed(0))
    return randomize(net, 1)


def outputs(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("dtype", DTYPES)
def test_stunet_no_grad_equals_autograd(dtype, count_passes):
    net = tiny_stunet(dtype)
    x = torch.randn(2, 1, 12, 8, 8, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        fused = outputs(net(x))
    blocks = sum(isinstance(m, BasicResBlock) for m in net.modules())
    assert len(count_passes) == 2 * blocks == 14
    count_passes.clear()
    recorded = outputs(net(x.requires_grad_()))
    assert not count_passes and all(r.requires_grad for r in recorded)
    for f, r in zip(fused, recorded):
        assert_same_bits(f, r.detach())


def old_block_forward(block, x):
    """BasicResBlock.forward as the op sequence, every module on its autograd path."""
    y = fn.leaky_relu(block.norm1(block.conv1(x)), 0.01)
    y = block.norm2(block.conv2(y))
    return fn.leaky_relu(y + (x if block.conv3 is None else block.conv3(x)), 0.01)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gradients_under_autograd_are_the_op_sequences(dtype, count_passes):
    net = tiny_stunet(dtype)
    blocks = [m for m in net.modules() if isinstance(m, BasicResBlock)]
    x = torch.randn(2, 1, 12, 8, 8, generator=torch.Generator().manual_seed(5))
    g_out = [torch.randn(o.shape, generator=torch.Generator().manual_seed(6)).to(o.dtype)
             for o in outputs(net(x))]

    def grads():
        net.zero_grad(set_to_none=True)
        torch.autograd.backward(outputs(net(x)), g_out)
        return [p.grad.clone() for p in net.parameters()]

    got = grads()
    assert not count_passes
    originals = {b: b.forward for b in blocks}
    for b in blocks:
        b.forward = lambda x, b=b: old_block_forward(b, x)
    try:
        want = grads()
    finally:
        for b, f in originals.items():
            b.forward = f
    for g, w in zip(got, want):
        assert_same_bits(g, w)


@pytest.mark.parametrize("norm", ["instance", "batch"])
def test_plain_conv_unet_no_grad_equals_autograd(norm, count_passes):
    net = PlainConvUNet(2, 3, 3, (8, 16, 16), [(3, 3, 3)] * 3, [(1, 1, 1), (2, 2, 2), (2, 2, 2)],
                        (2, 2, 2), (1, 1), norm=norm, dtype=torch.bfloat16,
                        generator=torch.Generator().manual_seed(0))
    randomize(net, 2)
    x = torch.randn(2, 2, 8, 8, 12, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        fused = outputs(net(x))
    assert len(count_passes) == 6 + 2  # a ConvNormAct each encoder and decoder conv
    recorded = outputs(net(x.requires_grad_()))
    for f, r in zip(fused, recorded):
        assert_same_bits(f, r.detach())


def test_decoder_bare_norms_no_grad_equal_autograd(count_passes):
    dec = randomize(LightDecoder(4, width=16, dtype=torch.bfloat16,
                                 generator=torch.Generator().manual_seed(0)), 3)
    g = torch.Generator().manual_seed(1)
    skips = [torch.randn(2, 16, 3, 3, 2, generator=g), torch.randn(2, 8, 6, 6, 4, generator=g)]
    skips = [s.to(torch.bfloat16).contiguous(memory_format=CL3D) for s in skips]
    with torch.no_grad():
        fused = dec(skips)
    assert len(count_passes) == 4  # two norms a UNetBlock, bare (no bias, no act)
    recorded = dec([s.requires_grad_() for s in skips])
    assert_same_bits(fused, recorded.detach())


def test_a_conv_without_bias_plus_its_bias_is_its_forward():
    conv = randomize(ConvND(4, 8, 3, 2, dtype=torch.bfloat16,
                            generator=torch.Generator().manual_seed(0)), 1)
    x = torch.randn(2, 4, 6, 5, 7, generator=torch.Generator().manual_seed(2))
    y = conv.without_bias(x) + conv.bias.to(torch.bfloat16).view(1, -1, 1, 1, 1)
    assert_same_bits(conv(x), y)


def test_a_norm_on_another_dtype_stays_on_the_op_sequence(count_passes):
    norm = InstanceNorm(8, dtype=torch.bfloat16)
    x = torch.randn(2, 8, 3, 4, 5)
    with torch.no_grad():
        out = norm(x)  # fp32 input to a bf16 norm: sums of the fp32 x, bf16 affine
    assert not count_passes and out.dtype == torch.bfloat16


def test_plain_path_counts_no_launch():
    y, a, b, bias, skip, skip_bias = operands((1, 2, 3, 4, 8), torch.float32, 1, seed=0)
    before = norm_act.launches
    norm_act(y, a, b, bias, True, skip, skip_bias)
    assert norm_act.launches == before


@pytest.mark.parametrize("bad", ["meta_device", "float16", "non_contiguous", "not_5d",
                                 "a_rows", "a_dtype", "bias_shape", "skip_dtype",
                                 "skip_bias_alone", "moments_bias"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    y, a, b, bias, skip, skip_bias = operands((2, 3, 4, 5, 8), torch.float32, 2, seed=1)
    if bad == "meta_device":
        y, a, b = y.to("meta"), a.to("meta"), b.to("meta")
    elif bad == "float16":
        y = y.half()
    elif bad == "non_contiguous":
        y = torch.rand(2, 3, 4, 8, 5).transpose(3, 4)
    elif bad == "not_5d":
        y = y[0]
    elif bad == "a_rows":
        a, b = a[:, :4], b[:, :4]
    elif bad == "a_dtype":
        a = a.double()
    elif bad == "bias_shape":
        bias = bias[:4]
    elif bad == "skip_dtype":
        skip = skip.to(torch.bfloat16)
    elif bad == "skip_bias_alone":
        skip = None
    with pytest.raises(ValueError):
        if bad == "moments_bias":
            row_moments_forward(y, None, True, bias=bias.to(torch.bfloat16))
        else:
            norm_act(y, a, b, bias, True, skip, skip_bias)


def test_kernel_is_filed_under_other():
    """benchmark/trace.py files the kernel under `other`, so it counts in none
    of elementwise_ms, conv_roofline's kernels, cudnn_ms or the moments."""
    src = (CSRC / "norm_act.cu").read_text()
    assert "norm_act_kernel(const T*" in src
    for t, vec in (("__nv_bfloat16", 8), ("float", 4), ("__nv_bfloat16", 1), ("float", 1)):
        name = (f"void norm_epilogue::norm_act_kernel<{t}, {vec}, true, true, true, "
                f"true>({t} const*, float const*, float const*, float const*, {t} const*, "
                f"float const*, {t}*, long long, int, int, int, int)")
        assert kernel_group(name) == "other"
    assert kernel_group("norm_act_kernel") == "other"


def test_build_path_tracks_the_source():
    path = _build.library_path("norm_act")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("norm_act-") and path.suffix == ".so"
    assert path != _build.library_path("moments")


# On the card ---------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU build")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(8, 128, 128, 128, 32), (8, 64, 64, 64, 64),
                                   (3, 7, 9, 11, 96), (2, 5, 6, 7, 12)])
def test_kernel_equals_plain_on_the_card(cuda, dtype, shape):
    """Stage 0 and 1 of the volume's tile batch, a ragged voxel count, and a
    C that takes element loads: every mode, bit for bit."""
    y, a, b, bias, skip, skip_bias = (t.to(cuda) for t in operands(shape, dtype, shape[0],
                                                                   seed=shape[-1]))
    for args in ((bias, True, None, None), (bias, True, skip, skip_bias),
                 (None, False, None, None), (None, True, skip, None)):
        for rows in (a.shape[0], 1):
            aa, bb = a[:rows].contiguous(), b[:rows].contiguous()
            got = norm_act(y, aa, bb, *args)
            assert_same_bits(got, norm_act_plain(y, aa, bb, *args))
    torch.cuda.synchronize()
    s, ss = row_moments_forward(y, None, True, bias=bias)
    s0, ss0 = row_moments_forward(y + bias.to(dtype), None, True)
    assert_same_bits(s, s0)
    assert_same_bits(ss, ss0)


@pytest.mark.card
@pytest.mark.parametrize("bad", ["float16", "non_contiguous", "a_on_cpu"])
def test_a_cuda_tensor_the_kernel_does_not_take_raises(cuda, bad):
    y, a, b, bias, skip, skip_bias = (t.to(cuda) for t in operands((2, 3, 4, 5, 16),
                                                                   torch.bfloat16, 2, seed=9))
    if bad == "float16":
        y = y.half()
    elif bad == "non_contiguous":
        y = y.transpose(1, 2)
    else:
        a = a.cpu()
    before = norm_act.launches
    with pytest.raises(ValueError):
        norm_act(y, a, b, bias, True, skip, skip_bias)
    assert norm_act.launches == before


@pytest.mark.card
def test_stunet_b_tile_launches_22_and_matches_autograd(cuda):
    from anatomask_torch.models.stunet import stunet_preset
    net = stunet_preset("base", 1, 3, pool_op_kernel_sizes=[(2, 2, 2)] * 5,
                        deep_supervision=False, dtype=torch.bfloat16, device=cuda)
    randomize(net, 0)
    x = torch.randn(2, 1, 128, 128, 128, generator=torch.Generator().manual_seed(1)).to(cuda)
    before = norm_act.launches
    with torch.no_grad():
        fused = net(x)
    assert norm_act.launches - before == 22
    recorded = net(x.requires_grad_())
    assert norm_act.launches - before == 22
    assert_same_bits(fused, recorded.detach())
