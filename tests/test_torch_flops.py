"""The port's FLOP counter (``utils/flops.py``) against the JAX package's
(CPU).

Exact on hand-computable toy modules (the counts of
``tests/test_flops_module.py``); on the tiny PARTNER frame, by top-level
module against JAX's ``per_module_flops``, equal once each stated
difference is applied (the transposed conv's stride^2, the dead probe
calls JAX's walk counts, the stem's method call, the attention's per-pair
RPE layer). The kernel wrappers' charges equal what the counter gives
their plain twins, so both routes of a frame count alike.
"""

import numpy as np
import pytest
import torch
from torch import nn

from torch_port_fixtures import (drawn_init, load_converted, randomize,
                                 synthetic_points, tiny_frame_cfg)

torch.set_num_threads(2)


class Inner(nn.Module):
    def __init__(self):
        super().__init__()
        self.Dense_0 = nn.Linear(32, 64)

    def forward(self, x):
        return self.Dense_0(x)


class M(nn.Module):
    """The toy of tests/test_flops_module.py: a Dense in a submodule, then
    a 3x3 "SAME" conv (NCHW here)."""

    def __init__(self):
        super().__init__()
        self.inner = Inner()
        self.conv = nn.Conv2d(64, 16, 3, padding=1)

    def forward(self, x):
        x = self.inner(x)
        return self.conv(x.reshape(1, 4, 4, 64).permute(0, 3, 1, 2))


def test_dense_and_conv_exact():
    from partner_tpu_torch.utils.flops import flops_of, per_module_flops

    m, x = M(), torch.ones(16, 32)
    tbl = per_module_flops(m, x)
    # Dense: 2*M*K*N; Conv: 2*prod(out)*in_ch*k_spatial, as in JAX
    assert tbl == {"M/conv": 2 * (1 * 4 * 4 * 16) * 64 * 9,
                   "M/inner/Dense_0": 2 * 16 * 32 * 64}
    assert per_module_flops(m, x, depth=2) == {
        "M/conv": 2 * (1 * 4 * 4 * 16) * 64 * 9,
        "M/inner": 2 * 16 * 32 * 64}
    assert flops_of(m, x) == sum(tbl.values())


def test_toy_counts_equal_jax():
    """The same toy in flax through JAX's walk: the same table."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    from partner_tpu.utils.flops import per_module_flops as jax_pmf
    from partner_tpu_torch.utils.flops import per_module_flops

    class JInner(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return fnn.Dense(64)(x)

    class JM(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            x = JInner(name="inner")(x)
            return fnn.Conv(16, (3, 3), name="conv")(x.reshape(1, 4, 4, 64))

    x = jnp.ones((16, 32))
    v = jax.eval_shape(JM().init, jax.random.PRNGKey(0), x)
    want = jax_pmf(lambda v, x: JM().apply(v, x), v, x)
    want = {k.replace("JM", "M"): int(n) for k, n in want.items()}
    assert per_module_flops(M(), torch.ones(16, 32)) == want


def test_depth_grouping_and_repeats():
    """A module called 5 times counts 5 times (JAX's scan multiplier);
    depth 1 groups everything under the root."""
    from partner_tpu_torch.utils.flops import per_module_flops

    class Loop(nn.Module):
        def __init__(self):
            super().__init__()
            self.d = nn.Linear(32, 32, bias=False)

        def forward(self, x):
            for _ in range(5):
                x = self.d(x)
            return x

    x = torch.ones(8, 32)
    assert per_module_flops(Loop(), x, depth=1) == {"Loop": 5 * 2 * 8 * 32
                                                    * 32}
    # FLOPs outside every module go to <top>
    assert per_module_flops(lambda a: a @ a.T, x) == {"<top>": 2 * 8 * 32 * 8}


def twin_cases(gen):
    """Small inputs of the three kernels that carry products, each with
    its plain twin and the charge formula."""
    from partner_tpu_torch.ops import stem, swin_attn, swin_block
    from partner_tpu_torch.utils import flops

    def r(*s):
        return torch.randn(*s, generator=gen)

    x = r(2, 10, 37)
    w1, w2 = r(32, 10), r(64, 32)
    stem_args = (x, torch.rand(2, 37, generator=gen) > 0.2, w1, r(32), r(32),
                 w2, r(64), r(64))
    q = r(6, 4, 64, 64)
    aw1, aw2 = r(2, 16), r(16, 4)
    attn_args = (q, r(6, 4, 64, 64), r(6, 4, 64, 64), r(6, 64, 2) * 10,
                 r(3, 64, 64), aw1, r(16), aw2, r(4), r(4).abs() + 0.1)
    c, nh, ws, m, vh = 32, 4, 8, 64, 16
    bx = r(1, 16, 8, c)
    params = {"ln1_scale": r(c), "ln1_bias": r(c), "vote_w1": r(3, vh),
              "vote_b1": r(vh), "vote_w2": r(vh, c), "vote_b2": r(c),
              "qkv_w": r(3 * c, c), "qkv_b": r(3 * c), "itau": r(nh).abs(),
              "proj_w": r(c, c), "proj_b": r(c), "ln2_scale": r(c),
              "ln2_bias": r(c), "fc1_w": r(m, c), "fc1_b": r(m),
              "fc2_w": r(c, m), "fc2_b": r(c)}
    block_args = (bx, r(1, 16, 8, 3), r(1, 2, 1, nh, 64, 64), params, nh, ws)
    return [
        ("stem", stem.stem2_channel_major_plain, stem_args,
         flops.stem_flops(x, w1, w2)),
        ("swin_attn", swin_attn.swin_vote_attention_plain, attn_args,
         flops.swin_attn_flops(q, aw1, aw2)),
        ("swin_block", swin_block.swin_vote_block_plain, block_args,
         flops.swin_block_flops(bx, params, nh, ws)),
    ]


def test_kernel_charges_equal_the_twins_counts():
    """Each wrapper's charge equals the counter's count of its plain twin
    at the same shapes; a charge lands on the modules that launched it,
    as the twin's ops do."""
    from partner_tpu_torch.utils import flops

    gen = torch.Generator().manual_seed(0)
    for name, twin, args, charge in twin_cases(gen):
        with flops.counting() as mode:
            twin(*args)
        assert mode.get_total_flops() == charge > 0, name

        class Twin(nn.Module):
            def forward(self):
                return twin(*args)

        class Kernel(nn.Module):
            def forward(self):
                flops.charge(name, charge)

        class Host(nn.Module):
            def __init__(self, inner):
                super().__init__()
                self.op = inner

            def forward(self):
                return self.op()

        plain = flops.per_module_flops(Host(Twin()))
        kernel = flops.per_module_flops(Host(Kernel()))
        assert plain == kernel == {"Host/op": charge}, name
    # no count active: nothing to charge, nothing kept
    assert not flops.active
    flops.charge("stem", 10)


def test_tiny_frame_by_top_level_module_against_jax():
    """The tiny PARTNER config's ``predict``, per top-level module: the
    port's count equals JAX's after the stated differences, each taken
    from JAX's own deeper table:
    - neck: XLA counts the stride-2 transposed conv's output pixels, the
      dilation's zeros included: JAX's = 4 x the port's;
    - SetBlocks (attns) and head: JAX's walk counts a dead (1, 2) probe of
      each position / RPE MLP (flax binds its parameters that way);
    - head: the port's inference attention (the kernel and its twin)
      computes the RPE MLP's first layer per pair, JAX's XLA route per
      cell: + 2 nB T T 2 hid - 2 nB T 2 hid a block;
    - backbone: the stem runs in ``encode_points``, a method: the port
      counts it under the root module, JAX under ``backbone``."""
    from partner_tpu.models import build_detector as jax_build
    from partner_tpu.utils.flops import per_module_flops as jax_pmf
    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.utils.flops import per_module_flops

    rng = np.random.RandomState(0)
    model_cfg, test_cfg = tiny_frame_cfg()
    # one transposed conv, the stride-2 deblock
    assert model_cfg["neck"]["us_layer_strides"] == [1, 2]
    pc_range = model_cfg["bbox_head"]["voxel_generator"]["range"]
    pts, mask = synthetic_points(rng, pc_range, 2000, 2400)
    ex = {"points": pts, "points_mask": mask}
    jdet = jax_build(model_cfg, None, test_cfg)
    v = randomize(drawn_init(jdet.module.init, rng,
                             {"points": pts[:, :64],
                              "points_mask": mask[:, :64]}, train=False), rng)
    jfn = lambda v, e: jdet.predict(v, e)
    jax2 = {k: int(n) for k, n in jax_pmf(jfn, v, ex, depth=2).items()}
    jdeep = {k: int(n) for k, n in jax_pmf(jfn, v, ex, depth=9).items()}

    tdet = build_detector(model_cfg, None, test_cfg, device="cpu")
    load_converted(tdet.module, v)
    tex = {k: torch.from_numpy(a) for k, a in ex.items()}
    with torch.no_grad():
        port2 = per_module_flops(tdet.predict, tex, depth=2)
        port3 = per_module_flops(tdet.predict, tex, depth=3)

    root = "VoxelNetModule"
    probes = {top: sum(n for k, n in jdeep.items()
                       if k.startswith(f"{root}/{top}/")
                       and k.rsplit("/", 2)[-2] in ("pos_mlp", "rpe"))
              for top in ("attns", "bbox_head")}
    n_probes = sum(1 for k in jdeep if k.endswith("/pos_mlp/Dense_0")
                   or k.endswith("/rpe/Dense_0"))
    assert n_probes == 8 and probes["attns"] == 6 * 192   # 2 x (2x2x16+16x4)
    # the head's two Swin blocks: windows of 8 x 8 on the 32 x 16 BEV
    nb, t, hid, blocks = 32 * 16 // 64, 64, 16, 2
    rpe_delta = blocks * 2 * nb * t * 2 * hid * (t - 1)
    deconv = {k: n for k, n in port3.items() if "ConvTranspose" in k}
    assert list(deconv) == [f"{root}/neck/ConvTranspose_0"]
    jdeconv = sum(n for k, n in jdeep.items() if "/neck/ConvTranspose" in k)
    assert jdeconv == 4 * deconv[f"{root}/neck/ConvTranspose_0"]

    assert port2[f"{root}/neck"] == jax2[f"{root}/neck"] - jdeconv + \
        deconv[f"{root}/neck/ConvTranspose_0"]
    assert port2[f"{root}/attns"] == jax2[f"{root}/attns"] - probes["attns"]
    assert port2[f"{root}/bbox_head"] == (
        jax2[f"{root}/bbox_head"] - probes["bbox_head"] + rpe_delta)
    assert port2[root] + port2[f"{root}/backbone"] == \
        jax2[f"{root}/backbone.encode_points"]
    assert sorted(port2) == sorted([root] + [f"{root}/{k}" for k in (
        "backbone", "attns", "neck", "bbox_head")])
    assert sum(port2.values()) == sum(port3.values()) == (
        sum(jax2.values()) - probes["attns"] - probes["bbox_head"]
        + rpe_delta - jdeconv + deconv[f"{root}/neck/ConvTranspose_0"])


def test_peaks_and_mfu():
    from partner_tpu_torch.utils import flops

    assert flops.device_peak_flops(name="NVIDIA H100 80GB HBM3") == 989e12
    assert flops.device_peak_flops("f32", "NVIDIA H100 80GB HBM3") == \
        67e12
    with pytest.raises(KeyError, match="NVIDIA A100-SXM4-80GB"):
        flops.device_peak_flops(name="NVIDIA A100-SXM4-80GB")
    assert not any("TPU" in k for k in flops.PEAK_FLOPS)
    assert flops.mfu(494.5e12, 1.0, peak=989e12) == 0.5
    assert flops.mfu(1e12, 0.01, peak=1e15) == pytest.approx(0.1)
    assert flops.mfu(1e12, 0.0, peak=1e15) == 0.0


def test_flops_report_cli(tmp_path, capsys):
    """``flops_report --device cpu`` on the tiny flagship cut: the printed
    table is ``per_module_flops`` of the same frame, and its total the
    matmul-class total of ``flops_of``."""
    from partner_tpu_torch.tools import flops_report
    from partner_tpu_torch.utils.flops import flops_of, per_module_flops

    from torch_port_fixtures import write_tiny_eval_config

    cfg = str(tmp_path / "tiny.py")
    write_tiny_eval_config(cfg, str(tmp_path / "unused.pkl"), str(tmp_path))
    tbl, total = flops_report.main(["--config", cfg, "--points", "2000",
                                    "--depth", "2", "--device", "cpu"])
    printed = capsys.readouterr().out.splitlines()
    assert printed[-1].split() == ["TOTAL", f"{total / 1e9:.2f}"]
    assert len(printed) == len(tbl) + 2
    det, ex = flops_report.build_frame(cfg, 2000, torch.device("cpu"))
    assert ex["points"].shape[:2] == (1, 2400)
    with torch.no_grad():
        assert per_module_flops(det.predict, ex, depth=2) == tbl
        assert flops_of(det.predict, ex) == total == sum(tbl.values())
