"""Where the conv kernels and their plain versions part from a float64
reference, and why. First kernel #2 (the per-tap rounded 3x3x3 conv,
ops/zslab_conv.py): a second witness for chip_smoke.py's bf16 gate (relative
max error <= 1e-2 against conv3d_zslab_plain) at the STUNet-H 192 -> 192
launch shapes; modes `fp32` and `k1h` (below) hold the float32 path's
variants of both kernels (tf32x3 and the fp32 stem) and kernel #1's bf16
hopper variant to float64 in the same way.

Each draw holds three implementations of the same function on the same
input against a float64 reference, y* = bf16(bf16(t0 + t1) + t2) with each
tap t_d the float64 sum of its 9 * C products rounded once to bf16 (round
half to even, done here on the float64 value, so no float32 step comes
between):

- the hopper variant (what the paths launch at 192 -> 192),
- the simple variant (csrc/conv3x3_igemm.cuh's wmma kernel, through its C
  entry point),
- the plain version (float32 matmuls, as chip_smoke.py compares).

It prints, per draw, the gate's number (hopper against plain) and, for each
pair, the largest distance in units of the bf16 ulp of the reference
element's binade and the count of elements at 1 and at >= 2 ulps. For the
worst element of a draw whose gate reads above 1e-2 (or of the last draw)
it prints the three float64 taps, how far each lies from a bf16 rounding
midpoint (in ulps of the tap), every implementation's rounded taps (each
read by running it with the other taps' weights zeroed), and the partial
sums that the bf16 additions round.

Modes (on the card; the kernels are built from csrc/ at the first launch):

    python tests/torch_zslab_roundoff.py search   # fresh draws, seeds 0.., at
                                                  # the H gates' 192 shapes
    python tests/torch_zslab_roundoff.py replay   # chip_smoke.py's kernel
        # phases with the stem table drawing from the phases' generator (so the
        # H gates see the inputs they would see then); every failed check is
        # printed instead of raised, and a failed kernel #2 gate gets the witness
    python tests/torch_zslab_roundoff.py taps     # each implementation's
        # rounded taps against the float64 ones (seed 20 at 64^3, B = 2)
    python tests/torch_zslab_roundoff.py time     # kernel #2's ms at its main
        # path shapes, one or more for each hopper tile
    python tests/torch_zslab_roundoff.py variants # the hopper variant built at
        # several promotion intervals: accuracy on seed 20 and ms at those shapes
    python tests/torch_zslab_roundoff.py fp32     # both kernels in float32 at
        # every launch shape of the B step and of a volume tile and at
        # chip_smoke.py's gated fp32 stems: the variant the rule picks (tf32x3,
        # or the stem), the simple variant and the plain version against a
        # float64 reference of each kernel's function; the variant must stay
        # within twice the plain version's distance (FP32_LIMIT)
    python tests/torch_zslab_roundoff.py k1h      # kernel #1's bf16 hopper
        # variant (one rounding) at the STUNet-H step's kernel #1 shapes
        # against the float64 sum rounded once to bf16, beside the plain version
    python tests/torch_zslab_roundoff.py k1variants  # kernel #1's hopper
        # variant built at several promotion intervals: k1h's shares and its ms
        # and totals at the B and H steps' kernel #1 shapes

Modes run in the order given.
"""
import math
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from anatomask_torch.ops.zslab_conv import (conv3d_zslab_forward,  # noqa: E402
                                            conv3d_zslab_plain)

CHUNK = 1 << 27  # elements per chunk of the elementwise statistics


round_bf16_64 = cs.round_bf16_64  # float64 -> the nearest bf16 value, as float32


def ulp_bf16(r):
    """The bf16 ulp of the binade of each element of r (float32)."""
    _, e = torch.frexp(r.float())
    return torch.ldexp(torch.ones_like(r, dtype=torch.float32), e - 8)


def reference(x, w, padding=1):
    """y* in bf16, chunked over the first output axis (float64 products)."""
    B, C = x.shape[0], x.shape[-1]
    D, H, W = (n + 2 * padding - 2 for n in x.shape[1:4])
    F = w.shape[-1]
    xp = torch.nn.functional.pad(x, (0, 0) + (padding,) * 6)
    w3 = w.reshape(3, 9 * C, F).double()
    out = torch.empty((B, D, H, W, F), dtype=torch.bfloat16, device=x.device)
    step = max(1, (1 << 30) // (8 * B * H * W * 9 * C))
    for d0 in range(0, D, step):
        d1 = min(D, d0 + step)
        acc = None
        for d in range(3):
            cols = [xp[:, d0 + d:d1 + d, dy:dy + H, dz:dz + W, :]
                    for dy in range(3) for dz in range(3)]
            patches = torch.cat(cols, dim=-1).double().reshape(-1, 9 * C)
            tap = round_bf16_64(patches @ w3[d]).to(torch.bfloat16)
            acc = tap if acc is None else acc + tap
        out[:, d0:d1] = acc.reshape(B, d1 - d0, H, W, F)
    return out


def ulp_stats(a, ref):
    """(largest |a - ref| in ulps of ref's binade, its flat index, count at
    exactly 1 ulp or less but above 0, count at >= 2 ulps)."""
    a, ref = a.reshape(-1), ref.reshape(-1)
    worst, where, n1, n2 = 0.0, 0, 0, 0
    for i in range(0, a.numel(), CHUNK):
        r = ref[i:i + CHUNK].float()
        d = (a[i:i + CHUNK].float() - r).abs() / ulp_bf16(r)
        j = int(d.argmax())
        if d[j].item() > worst:
            worst, where = d[j].item(), i + j
        n1 += int(((d > 0) & (d <= 1)).sum())
        n2 += int((d >= 2).sum())
    return worst, where, n1, n2


def simple(x, w):
    return cs.simple_forward(x, w, 1)


IMPLS = (("hopper", conv3d_zslab_forward), ("simple", simple), ("plain", conv3d_zslab_plain))


def witness(x, w, label, detail):
    """The three implementations against y* and against each other; with
    `detail`, the worst element's taps. Returns the gate's number."""
    ys = {name: f(x, w) for name, f in IMPLS}
    ref = reference(x, w)
    torch.cuda.synchronize()
    gate = cs.rel_err(ys["hopper"], ys["plain"])
    lines = [f"[witness] {label}: gate (hopper vs plain, rel. max error) {gate:.4e}"
             f"{' > 1e-2' if gate > 1e-2 else ''}; max |y*| {ref.float().abs().max().item()}"]
    worst = None
    for a, b in (("hopper", "plain"), ("hopper", "simple"), ("hopper", "y*"),
                 ("simple", "y*"), ("plain", "y*")):
        u, where, n1, n2 = ulp_stats(ys[a], ref if b == "y*" else ys[b])
        rel = cs.rel_err(ys[a], ref if b == "y*" else ys[b])
        lines.append(f"[witness]   {a} vs {b}: rel {rel:.4e}, max {u:g} ulp, elements at "
                     f"<= 1 ulp {n1}, at >= 2 ulp {n2}")
        if (a, b) == ("hopper", "plain"):
            worst = where
    print("\n".join(lines), flush=True)
    if detail:
        explain(x, w, ys, ref, worst)
    del ys, ref
    torch.cuda.empty_cache()
    return gate


def explain(x, w, ys, ref, flat):
    """The worst element's taps: float64, their distance to a bf16 midpoint,
    every implementation's rounded taps and the rounded partial sums."""
    B, X, Y, Z, F = ys["plain"].shape
    f = flat % F
    b, i, j, k = (flat // F) // (X * Y * Z), (flat // (F * Y * Z)) % X, \
        (flat // (F * Z)) % Y, (flat // F) % Z
    xp = torch.nn.functional.pad(x, (0, 0) + (1,) * 6)
    nb = xp[b, i:i + 3, j:j + 3, k:k + 3, :].double()  # (3, 3, 3, C)
    t64 = (nb * w[..., f].double()).reshape(3, -1).sum(1)
    print(f"[witness]   worst element (b, x, y, z, f) = {(b, i, j, k, f)}: hopper "
          f"{ys['hopper'].reshape(-1)[flat].item()}, simple {ys['simple'].reshape(-1)[flat].item()}, "
          f"plain {ys['plain'].reshape(-1)[flat].item()}, y* {ref.reshape(-1)[flat].item()}")
    for d in range(3):
        t = t64[d].item()
        m, e = math.frexp(t)
        frac = abs(m) * 256.0 - math.floor(abs(m) * 256.0)
        print(f"[witness]   tap {d}: float64 {t!r}, {abs(frac - 0.5):.3e} ulp from a bf16 "
              f"midpoint, bf16 {round_bf16_64(t64[d:d + 1]).item()}")
    taps = {}
    for name, fn_ in IMPLS:
        vals = []
        for d in range(3):
            wd = torch.zeros_like(w)
            wd[d] = w[d]
            vals.append(fn_(x, wd)[b, i, j, k, f].float().item())
        taps[name] = vals
    taps["y*"] = [round_bf16_64(t64[d:d + 1]).item() for d in range(3)]

    def rnd(v):
        return round_bf16_64(torch.tensor([v], dtype=torch.float64)).item()

    for name, (t0, t1, t2) in taps.items():
        p = rnd(t0 + t1)
        print(f"[witness]   {name}: taps {t0}, {t1}, {t2}; t0 + t1 = {t0 + t1!r} -> {p}; "
              f"+ t2 = {p + t2!r} -> {rnd(p + t2)}")


def h_shapes():
    """(B, (X, Y, Z)) of every per-tap 192 -> 192 launch of the H gates."""
    out = []
    for batch, sites in ((cs.H_MICRO, cs.H_SITES), (cs.BATCH, cs.H_SITES),
                         (cs.SUP_BATCH, cs.H_SUP_SITES)):
        for _, C, F, vol in sites:
            if (C, F) == (192, 192) and cs.per_tap(vol) and (batch, vol) not in out:
                out.append((batch, vol))
    return out


def search(draws_small=24, draws_large=3):
    failed, top = [], (0.0, None)
    for batch, vol in sorted(h_shapes(), key=lambda s: s[0] * math.prod(s[1])):
        n = draws_small if math.prod(vol) * batch <= 2 * 64 ** 3 else draws_large
        for seed in range(n):
            gen = torch.Generator(device="cuda").manual_seed(seed)
            x, w = cs.conv_inputs(192, 192, vol, batch, torch.bfloat16, gen)
            gate = witness(x, w, f"B={batch} 192->192 @{vol} seed {seed}", detail=False)
            top = max(top, (gate, (batch, vol, seed)), key=lambda t: t[0])
            if gate > 1e-2:
                failed.append((batch, vol, seed))
                if len(failed) <= 2:
                    witness(x, w, f"B={batch} 192->192 @{vol} seed {seed} (again)", detail=True)
            del x, w
    print(f"[search] draws above the gate's 1e-2: {failed}")
    if not failed:  # the worst draw's element instead
        batch, vol, seed = top[1]
        x, w = cs.conv_inputs(192, 192, vol, batch, torch.bfloat16,
                              torch.Generator(device="cuda").manual_seed(seed))
        witness(x, w, f"B={batch} 192->192 @{vol} seed {seed} (the largest gate)", detail=True)


def tap_sums(x, w, d):
    """The float64 sums of first-axis tap d at every output element."""
    B, C = x.shape[0], x.shape[-1]
    D, H, W = x.shape[1:4]
    F = w.shape[-1]
    xp = torch.nn.functional.pad(x, (0, 0) + (1,) * 6)
    wd = w[d].reshape(9 * C, F).double()
    out = torch.empty((B, D, H, W, F), dtype=torch.float64, device=x.device)
    step = max(1, (1 << 30) // (8 * B * H * W * 9 * C))
    for d0 in range(0, D, step):
        d1 = min(D, d0 + step)
        cols = [xp[:, d0 + d:d1 + d, dy:dy + H, dz:dz + W, :]
                for dy in range(3) for dz in range(3)]
        patches = torch.cat(cols, dim=-1).double().reshape(-1, 9 * C)
        out[:, d0:d1] = (patches @ wd).reshape(B, d1 - d0, H, W, F)
    return out


def taps(batch=2, vol=(64, 64, 64), seed=20):
    """Each implementation's rounded taps (run with the other taps' weights
    zeroed) against the float64 tap sums rounded once: the share of taps
    rounded the other way, the share of those rounded toward zero, and the
    largest distance from a bf16 midpoint (in ulps of the tap) of a tap
    rounded the other way, which bounds that implementation's float32 error
    from below."""
    x, w = cs.conv_inputs(192, 192, vol, batch, torch.bfloat16,
                          torch.Generator(device="cuda").manual_seed(seed))
    for d in range(3):
        exact = tap_sums(x, w, d)
        right = round_bf16_64(exact)
        m, _ = torch.frexp(exact)
        mid = ((m.abs() * 256.0).frac() - 0.5).abs()
        wd = torch.zeros_like(w)
        wd[d] = w[d]
        line = []
        for name, f in IMPLS:
            t = f(x, wd).float()
            wrong = t != right
            n = int(wrong.sum())
            down = int((wrong & (t.abs() < right.abs())).sum())
            far = mid[wrong].max().item() if n else 0.0
            line.append(f"{name} {n / t.numel():.3e} of {t.numel()} (toward zero {down / max(n, 1):.3f}, "
                        f"farthest {far:.3e} ulp from a midpoint)")
            del t, wrong
        print(f"[taps] B={batch} 192->192 @{vol} seed {seed}, tap {d}: rounded the other way: "
              + "; ".join(line), flush=True)
        del exact, right, m, mid
    torch.cuda.empty_cache()


# kernel #2's launch shapes on the main paths, one or more for each hopper tile:
# (B, (X, Y, Z), C, F)
TIMED = ((4, (112, 112, 128), 32, 32), (4, (56, 56, 64), 64, 64), (8, (64, 64, 64), 64, 64),
         (8, (32, 32, 32), 128, 128), (2, (112, 112, 128), 96, 96), (2, (56, 56, 64), 192, 192))


def time():
    gen = torch.Generator(device="cuda").manual_seed(0)
    for batch, vol, C, F in TIMED:
        x, w = cs.conv_inputs(C, F, vol, batch, torch.bfloat16, gen)
        ms = cs.time_ms(lambda: conv3d_zslab_forward(x, w), 5)
        r = cs.rel_err(conv3d_zslab_forward(x, w), conv3d_zslab_plain(x, w))
        print(f"[time] kernel #2 B={batch} {C}->{F} @{vol} (tile {cs.conv_mod.igemm_tile(C, F)}):"
              f" {ms:.4f} ms, rel err {r:.3e}", flush=True)
        del x, w
        torch.cuda.empty_cache()


def build_promoted(name, groups, macro="CONV3X3_PROMOTE"):
    """csrc/<name>.cu built once for each promotion interval in `groups` (the
    hopper variant's CONV3X3_PROMOTE, or `macro`), in parallel: {g: (library,
    ptxas report)}, and `use(g)`, which sends the port's launches of that
    library to build g (`use(None)`: back to the port's own build)."""
    import ctypes
    import subprocess
    from concurrent.futures import ThreadPoolExecutor

    from anatomask_torch.ops import _build

    def build(g):
        out = _build.BUILD_DIR / f"{name}-promote{g}.so"
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        res = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, f"-D{macro}={g}",
                              "-o", str(out), str(_build.CSRC / f"{name}.cu")],
                             capture_output=True, text=True, check=True)
        return out, res.stdout + res.stderr

    with ThreadPoolExecutor(len(groups)) as pool:
        built = dict(zip(groups, pool.map(build, groups)))
    load = _build.load
    libs = {g: ctypes.CDLL(str(path)) for g, (path, _) in built.items()}

    def use(g):
        cs.conv_mod._build.load = (load if g is None
                                   else lambda lib: libs[g] if lib == name else load(lib))
        cs.conv_mod._entry.cache_clear()

    return built, use


def variants(groups=(1, 2, 3, 4, 6, 9, 1000)):
    """csrc/zslab_conv.cu built once for each promotion interval (the hopper
    variant's CONV3X3_PROMOTE: K steps whose products chain on the tensor
    cores before the FP32 pipe adds them to the tap's sum; 1000 is more than
    any tap has, i.e. a whole tap chains), each with its ptxas report of the
    per-tap kernels, the share of taps rounded the other way (tap 0 of seed 20
    at 64^3, B = 2, as `taps`), the gate and distance to y* on that draw, and
    kernel #2's ms at TIMED (its variants timed in turn, twice)."""
    import re

    built, use = build_promoted("zslab_conv", groups)

    x, w = cs.conv_inputs(192, 192, (64, 64, 64), 2, torch.bfloat16,
                          torch.Generator(device="cuda").manual_seed(20))
    right = round_bf16_64(tap_sums(x, w, 0))
    w0 = torch.zeros_like(w)
    w0[0] = w[0]
    ref = reference(x, w)
    plain = conv3d_zslab_plain(x, w)
    for g in groups:
        use(g)
        report, entry, spills = [], "", ""
        for ln in built[g][1].splitlines():  # the per-tap hopper kernels, and warnings
            if m := re.search(r"Compiling entry function '(\w+)'", ln):
                entry = cs.kernel_label(m[1]) if "wgmma" in m[1] and "Lb1E" in m[1] else ""
            elif m := re.search(r"(\d+) bytes spill stores", ln):
                spills = m[1]
            elif (m := re.search(r"Used (\d+) registers", ln)) and entry:
                report.append(f"{entry}: {m[1]} registers, {spills} bytes spilled")
            elif "warning" in ln:
                report.append(ln.strip())
        wrong = (conv3d_zslab_forward(x, w0).float() != right).float().mean().item()
        y = conv3d_zslab_forward(x, w)
        u, _, n1, n2 = ulp_stats(y, ref)
        print(f"[variants] PROMOTE={g}: tap 0 rounded the other way {wrong:.3e}; gate "
              f"{cs.rel_err(y, plain):.4e}; vs y* rel {cs.rel_err(y, ref):.4e}, {n1 + n2} "
              f"elements differ", flush=True)
        for ln in report:
            print(f"[variants]   ptxas: {ln}")
        del y
    del x, w, w0, right, ref, plain
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for batch, vol, C, F in TIMED:
        x, w = cs.conv_inputs(C, F, vol, batch, torch.bfloat16, gen)
        times = {g: [] for g in groups}
        for _ in range(2):
            for g in groups:
                use(g)
                times[g].append(cs.time_ms(lambda: conv3d_zslab_forward(x, w), 5))
        print(f"[variants] B={batch} {C}->{F} @{vol} (tile {cs.conv_mod.igemm_tile(C, F)}) ms: "
              + ", ".join(f"{g}: {min(t):.4f}" for g, t in times.items()), flush=True)
        del x, w
        torch.cuda.empty_cache()
    use(None)


def conv64(x, w, first_axis=None):
    """The float64 conv of x (NDHWC) by w (DHWIO) at padding 1, as NDHWC;
    with `first_axis` d, that first-axis tap's alone (a (1, 3, 3) conv of
    the input shifted by d - 1 along the first axis)."""
    if first_axis is None:
        return cs.conv64(x, w)
    xc = x.permute(0, 4, 1, 2, 3).double()
    wc = w.permute(4, 3, 0, 1, 2).double()
    D = x.shape[1]
    xp = torch.nn.functional.pad(xc, (0, 0, 0, 0, 1, 1))[:, :, first_axis:first_axis + D]
    y = torch.nn.functional.conv3d(xp, wc[:, :, first_axis:first_axis + 1], padding=(0, 1, 1))
    return y.permute(0, 2, 3, 4, 1)


def fp32_reference(x, w, per_tap):
    """Kernel #1's function from float64 (the 27 * C products summed in
    float64, rounded once to fp32) or, `per_tap`, kernel #2's (each
    first-axis tap's 9 * C products summed in float64 and rounded to fp32,
    the three taps added in fp32 in the order 0, 1, 2)."""
    if not per_tap:
        return conv64(x, w).float()
    t = [conv64(x, w, d).float() for d in range(3)]
    return (t[0] + t[1]) + t[2]


def rel_stats(y, ref):
    """(largest |y - ref| against the largest |ref|, root mean square of y -
    ref against that of ref)."""
    d = (y.double() - ref.double())
    return (d.abs().max() / ref.double().abs().max()).item(), \
        (d.square().mean().sqrt() / ref.double().square().mean().sqrt()).item()


FP32_LIMIT = 2.0  # a variant's distance from float64 at most this many times the plain version's


def fp32(seed=0):
    """Both kernels' fp32 variants (tf32x3; the stems' stem variant on the
    FP32 pipe), their simple variant and their plain versions against
    fp32_reference at every fp32 launch shape of the float32 B step and
    volume tile (chip_smoke.fp32_launches) and at chip_smoke.FP32_STEM_SHAPES
    (kernel #2), inputs as chip_smoke.py draws them."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    worst, failed = {}, []
    shapes = ([(path, batch, *launch) for path, batch in cs.FP32_PATHS.items()
               for launch in cs.fp32_launches(path)]
              + [(label, batch, "zslab", C, F, vol)
                 for label, batch, C, F, vol in cs.FP32_STEM_SHAPES])
    for path, batch, kernel, C, F, vol in shapes:
        per = kernel == "zslab"
        x, w = cs.conv_inputs(C, F, vol, batch, torch.float32, gen)
        variant = cs.igemm_variant(x, w)
        ref = fp32_reference(x, w, per)
        fwd, plain = ((conv3d_zslab_forward, conv3d_zslab_plain) if per
                      else (cs.conv3d_3x3_forward, cs.conv3d_3x3_plain))
        stats = {variant: rel_stats(fwd(x, w), ref),
                 "simple": rel_stats(cs.simple_forward(x, w, 1, per), ref),
                 "plain": rel_stats(plain(x, w), ref)}
        ratio = stats[variant][0] / stats["plain"][0]
        worst[variant] = max(worst.get(variant, 0.0), ratio)
        if ratio > FP32_LIMIT:
            failed.append((path, kernel, C, F, vol))
        print(f"[fp32] {path} kernel #{2 if per else 1} B={batch} {C}->{F} @{vol}: "
              f"distance from float64 (max, rms relative): "
              + ", ".join(f"{k} {m:.3e} {r:.3e}" for k, (m, r) in stats.items())
              + f"; {variant} / plain {ratio:.3f}", flush=True)
        del x, w, ref
        torch.cuda.empty_cache()
    print("[fp32] at most " + ", ".join(f"{v} {r:.3f}x" for v, r in worst.items())
          + f" the plain version's distance from float64 (limit {FP32_LIMIT}); shapes over "
          f"it: {failed}")


def k1_h_shapes():
    """(B, C, F, (X, Y, Z)) of kernel #1's launches in the STUNet-H step
    (microbatch B = 2): the forwards below MIN_VOLUME voxels and every dx."""
    out = []
    for i, (_, C, F, vol) in enumerate(cs.H_SITES):
        keys = [] if cs.per_tap(vol) else [(C, F)]
        if i > 0:
            keys.append((F, C))
        for c, f in keys:
            if (cs.H_MICRO, c, f, vol) not in out:
                out.append((cs.H_MICRO, c, f, vol))
    return out


def k1_reference(x, w):
    """bf16(the float64 sum of the 27 * C products), rounded once."""
    return round_bf16_64(conv64(x, w)).to(torch.bfloat16)


def k1h(seed=0):
    """Kernel #1's bf16 hopper variant at k1_h_shapes against k1_reference:
    the share of elements that round to another bf16 value than the float64
    sum, and the largest distance in ulps, beside the plain version's (fp32
    sums on cuBLAS, rounded once). ROADMAP.md section 3's check of kernel #1's
    chain of 27 * C products on wgmma."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for batch, C, F, vol in k1_h_shapes():
        x, w = cs.conv_inputs(C, F, vol, batch, torch.bfloat16, gen)
        ref = k1_reference(x, w)
        line = []
        for name, f in (("hopper", cs.conv3d_3x3_forward), ("plain", cs.conv3d_3x3_plain)):
            y = f(x, w)
            u, _, n1, n2 = ulp_stats(y, ref)
            line.append(f"{name} {(n1 + n2) / y.numel():.3e} of {y.numel()} rounded otherwise "
                        f"(max {u:g} ulp, {n2} at >= 2)")
            del y
        print(f"[k1h] B={batch} {C}->{F} @{vol} (K = {27 * C}, "
              f"{cs.igemm_variant(x, w)}): " + "; ".join(line), flush=True)
        del x, w, ref
        torch.cuda.empty_cache()


def k1_step_counts(sites, micro, forwards):
    """{(B, C, F, (X, Y, Z)): kernel #1's launches in one step}: `forwards`(name)
    forwards of each site below MIN_VOLUME voxels and `micro` dx of each but
    the stem, at the microbatch B = cs.BATCH // micro."""
    batch, out = cs.BATCH // micro, {}
    for i, (name, C, F, vol) in enumerate(sites):
        for key, n in (((batch, C, F, vol), 0 if cs.per_tap(vol) else forwards(name)),
                       ((batch, F, C, vol), micro if i > 0 else 0)):
            if n:
                out[key] = out.get(key, 0) + n
    return out


K1_PROMOTE_LIMIT = 2.0  # kernel #1's share rounded otherwise, at most this x the plain version's


def k1variants(groups=(4, 8, 16, 32, 1000)):
    """csrc/conv3x3.cu (kernel #1 alone) built once for each promotion
    interval (CONV3X3_PROMOTE_ONCE; 1000 chains all of K at every shape of the
    paths): at each k1h shape the share of elements that the hopper variant
    rounds to another bf16 value than k1_reference, against the plain
    version's (within K1_PROMOTE_LIMIT x it or not), then kernel #1's ms at
    the B and H steps' kernel #1 shapes, the builds timed in turn, twice,
    and the two steps' kernel #1 totals for each interval."""
    built, use = build_promoted("conv3x3", groups, "CONV3X3_PROMOTE_ONCE")
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = dict.fromkeys(groups, 0.0)
    for batch, C, F, vol in k1_h_shapes():
        x, w = cs.conv_inputs(C, F, vol, batch, torch.bfloat16, gen)
        ref = k1_reference(x, w)
        plain = (cs.conv3d_3x3_plain(x, w).float() != ref.float()).float().mean().item()
        shares = {}
        for g in groups:
            use(g)
            shares[g] = (cs.conv3d_3x3_forward(x, w).float() != ref.float()).float().mean().item()
            worst[g] = max(worst[g], shares[g] / plain)
        print(f"[k1variants] B={batch} {C}->{F} @{vol} (K = {27 * C}): rounded otherwise: plain "
              f"{plain:.3e}; " + ", ".join(f"{g}: {v:.3e} ({v / plain:.2f}x)"
                                          for g, v in shares.items()), flush=True)
        del x, w, ref
        torch.cuda.empty_cache()
    print("[k1variants] worst share against the plain version's (limit "
          f"{K1_PROMOTE_LIMIT}x): " + ", ".join(f"{g}: {v:.2f}x" for g, v in worst.items()))
    steps = {"B step": k1_step_counts(cs.SITES, 1, lambda name: 2),
             "H step": k1_step_counts(cs.H_SITES, cs.H_CFG.grad_accum_steps,
                                      lambda name: cs.h_forwards(name, cs.H_CFG.grad_accum_steps))}
    ms = {}
    for counts in steps.values():
        for batch, C, F, vol in counts:
            if (batch, C, F, vol) in ms:
                continue
            x, w = cs.conv_inputs(C, F, vol, batch, torch.bfloat16, gen)
            times = {g: [] for g in groups}
            for _ in range(2):
                for g in groups:
                    use(g)
                    times[g].append(cs.time_ms(lambda: cs.conv3d_3x3_forward(x, w), 3))
            ms[(batch, C, F, vol)] = {g: min(t) for g, t in times.items()}
            print(f"[k1variants] B={batch} {C}->{F} @{vol} ms: "
                  + ", ".join(f"{g}: {t:.4f}" for g, t in ms[(batch, C, F, vol)].items()),
                  flush=True)
            del x, w
            torch.cuda.empty_cache()
    for label, counts in steps.items():
        print(f"[k1variants] kernel #1 in one {label}: "
              + ", ".join(f"{g}: {sum(n * ms[k][g] for k, n in counts.items()):.3f} ms"
                          for g in groups))
    use(None)


def replay():
    stash = {}
    failures = []
    conv_inputs, check = cs.conv_inputs, cs.check

    def record_inputs(C, F, vol, batch, dtype, gen):
        stash["xw"] = conv_inputs(C, F, vol, batch, dtype, gen)
        stash["label"] = f"B={batch} {C}->{F} @{vol}"
        return stash["xw"]

    def soft_check(cond, msg):
        if cond:
            return
        failures.append(msg)
        print(f"[replay] check failed: {msg}", flush=True)
        if msg.startswith("zslab") and "rel errors" in msg:
            x, w = stash["xw"]
            witness(x, w, f"replay {stash['label']}", detail=True)

    cs.conv_inputs, cs.check = record_inputs, soft_check
    gen = torch.Generator(device="cuda").manual_seed(0)
    _, _, _, _, _, _, k1_step, k1_infer = cs.conv_phase(gen)
    cs.free_memory()
    cs.stem_table(gen)  # the phases' generator, as the stem table first drew
    cs.free_memory()
    cs.zconcat_phase(gen, k1_step, k1_infer)
    cs.free_memory()
    cs.moments_phase(gen)
    cs.free_memory()
    cs.zslab_phase(gen)
    cs.free_memory()
    cs.supervised_gate_phase(gen)
    cs.free_memory()
    cs.h_gate_phase(gen)
    print(f"[replay] failed checks: {len(failures)}")


def main():
    if not torch.cuda.is_available():
        print("torch_zslab_roundoff: needs the card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {cs.gpu_line()}", flush=True)
    for mode in sys.argv[1:] or ["search"]:
        {"search": search, "replay": replay, "taps": taps, "time": time,
         "variants": variants, "fp32": fp32, "k1h": k1h, "k1variants": k1variants}[mode]()
    return 0


if __name__ == "__main__":
    sys.exit(main())
