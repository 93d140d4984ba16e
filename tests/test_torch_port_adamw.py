"""The multi-tensor AdamW kernel (``kernels/adamw.py``, ``csrc/adamw.cu``) and
``train/state.py::apply_optimizer``'s choice of path.

On the CPU (cheap, in tier-1):

- ``adamw_plain`` (the kernel's arithmetic in plain PyTorch) against torch's
  AdamW over 20 f32 steps, at the repository's AdamW tolerance (rtol 1e-5 /
  atol 1e-7);
- ``apply_optimizer`` on CPU leaves still takes torch's foreach AdamW, bit for
  bit, and never the kernel;
- the launch's block table (``block_starts``): every chunk of every leaf
  once, one block for an empty leaf; and the key of what a launch carries
  changes when a state tensor or a parameter's ``.data`` is replaced;
- a CPU leaf, and more leaves than a launch carries, are refused.

On a card (``cuda`` marker; they skip here): the kernel against
``torch.optim.AdamW(foreach=True, capturable=True)`` over 20 steps
(parameters, moments and step counts) on awkward, misaligned and empty leaves
and on DrugLAMP2C2P's leaf list, bit-identical repeats, a checkpoint of torch's capturable AdamW
loaded mid-run (and the kernel's loaded into torch's), the launch's table
rebuilt after ``load_state_dict``, the refusals, and the launches: one an optimizer
step, three AdamW kernels in a full-gate step's optimizer phases where torch
issues hundreds.

The file imports neither JAX nor the JAX package, so on a machine with a card
it runs on its own:

    python -m pytest tests/test_torch_port_adamw.py --noconftest -q
"""

import copy
import io

import numpy as np
import pytest
import torch

from druglamp_tpu_torch.kernels import adamw
from druglamp_tpu_torch.train import state as state_mod
from druglamp_tpu_torch.train.state import apply_optimizer, make_adamw

STEPS = 20
LRS = [1e-3 * (0.9 ** k) for k in range(STEPS)]      # the LR moves step to step, as scheduled
AWKWARD = [(1,), (3,), (5, 7), (4097,), (130, 33), (64,)]


def _leaves(shapes, device="cpu", seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.nn.Parameter(torch.randn(s, generator=g).to(device)) for s in shapes]


def _grads(params, k, seed=1):
    g = torch.Generator().manual_seed(seed * 1000 + k)
    return [torch.randn(p.shape, generator=g).to(p.device) for p in params]


def _close(a, b, msg=""):
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7, msg=msg)


# --- on the CPU -----------------------------------------------------------------------------

@pytest.mark.parametrize("shapes", [AWKWARD, [(256, 128), (128,), (1,)]])
def test_plain_matches_torch_adamw(shapes):
    """``adamw_plain`` over 20 steps of seeded gradients and moving LRs against
    torch's AdamW with the reference's settings: parameters, moments, steps."""
    ours, ref = _leaves(shapes), _leaves(shapes)
    m = [torch.zeros_like(p) for p in ours]
    v = [torch.zeros_like(p) for p in ours]
    t = [torch.zeros((), dtype=torch.float32) for _ in ours]
    opt = make_adamw(ref)
    for k, lr in enumerate(LRS):
        grads = _grads(ours, k)
        adamw.adamw_plain(ours, grads, m, v, t, lr)
        for p, g in zip(ref, grads):
            p.grad = g
        opt.param_groups[0]["lr"] = lr
        opt.step()
    for i, p in enumerate(ref):
        s = opt.state[p]
        _close(ours[i].detach(), p.detach(), f"leaf {i}")
        _close(m[i], s["exp_avg"], f"exp_avg {i}")
        _close(v[i], s["exp_avg_sq"], f"exp_avg_sq {i}")
        assert float(t[i]) == float(s["step"]) == STEPS


def test_cpu_leaves_take_torch_adamw_bit_for_bit(monkeypatch):
    """``apply_optimizer`` on CPU leaves is torch's foreach step as before:
    bit-identical to ``opt.step()`` with the same ``.grad``, a None ``.grad``
    stepping as zeros, the step counts on the CPU, and the kernel never called."""
    def refuse(*a, **k):
        raise AssertionError("the kernel ran for CPU leaves")

    monkeypatch.setattr(adamw, "step", refuse)
    ours, ref = _leaves(AWKWARD), _leaves(AWKWARD)
    opt, ref_opt = make_adamw(ours), make_adamw(ref)
    for k, lr in enumerate(LRS):
        grads = _grads(ours, k)
        grads[0] = None
        for p, q, g in zip(ours, ref, grads):
            p.grad = g
            q.grad = torch.zeros_like(q) if g is None else g
        apply_optimizer(opt, lr)
        ref_opt.param_groups[0].update(lr=lr, capturable=False)
        ref_opt.step()
    for p, q in zip(ours, ref):
        assert torch.equal(p, q)
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(opt.state[p][key], ref_opt.state[q][key])
        assert opt.state[p]["step"].device.type == "cpu"
    assert opt.param_groups[0]["capturable"] is False


@pytest.mark.parametrize("sizes", [[1], [3, 4096, 0, 4097], [1_048_576, 5, 2 * 4096, 0]])
def test_table_covers_every_chunk_once(sizes):
    """``block_starts``: each leaf's blocks follow the last leaf's, one for
    each chunk of ``CHUNK`` entries and one for an empty leaf, so a block's
    leaf (the last whose first block is at or before it, as the kernel's
    binary search finds it) and chunk cover every chunk of every leaf once."""
    first = adamw.block_starts(sizes)
    assert first[0] == 0 and len(first) == len(sizes) + 1
    assert all(b > a for a, b in zip(first, first[1:]))
    blocks = [(leaf, block - first[leaf]) for block in range(first[-1])
              for leaf in [int(np.searchsorted(first, block, side="right")) - 1]]
    want = [(i, c) for i, size in enumerate(sizes)
            for c in range(max(1, -(-size // adamw.CHUNK)))]
    assert blocks == want


def test_table_key_follows_every_pointer():
    """The key of what a launch carries (each leaf's pointers and size)
    changes when a state tensor, a parameter's ``.data`` or a leaf's size
    changes, and not otherwise; () before the first step."""
    params = _leaves([(4, 3), (5,)])
    opt = make_adamw(params)
    assert adamw._key(params, opt.state) == ()
    for p in params:
        opt.state[p].update(step=torch.zeros(()), exp_avg=torch.zeros_like(p),
                            exp_avg_sq=torch.zeros_like(p))
    key = adamw._key(params, opt.state)
    assert len(key) == 5 * len(params) and key == adamw._key(params, opt.state)
    opt.state[params[1]]["exp_avg_sq"] = torch.zeros_like(params[1])
    assert adamw._key(params, opt.state) != key
    key = adamw._key(params, opt.state)
    params[0].data = params[0].data.clone()
    assert adamw._key(params, opt.state) != key
    key = adamw._key(params, opt.state)
    params[1].data = params[1].data[:2]                # the same pointer, another size
    assert adamw._key(params, opt.state) != key


@pytest.mark.parametrize("leaves,refusal", [(1, "not on the card"),
                                             (adamw.MAX_LEAVES + 1, "at most 448")])
def test_kernel_refuses_cpu_leaves_and_too_many(leaves, refusal):
    """A CPU leaf, and more leaves than one launch's arguments carry, raise."""
    params = _leaves([(3,)] * leaves)
    for p in params:
        p.grad = torch.zeros_like(p)
    with pytest.raises(ValueError, match=refusal):
        adamw.step(make_adamw(params), 1e-3)


# --- on a card -------------------------------------------------------------------------------

pytest_card = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _torch_capturable(params):
    return torch.optim.AdamW(params, lr=0.0, betas=(adamw.B1, adamw.B2), eps=adamw.EPS,
                             weight_decay=adamw.WEIGHT_DECAY, foreach=True, capturable=True)


def _run(opt, params, steps, first=0, kernel=True):
    for k in range(first, first + steps):
        for p, g in zip(params, _grads(params, k)):
            p.grad = g
        if kernel:
            apply_optimizer(opt, LRS[k])
        else:
            opt.param_groups[0]["lr"] = LRS[k]
            opt.step()


def _assert_same_state(opt, params, ref_opt, ref_params, exact=False):
    check = (lambda a, b, msg: torch.testing.assert_close(a, b, rtol=0, atol=0, msg=msg)) \
        if exact else _close
    for i, (p, q) in enumerate(zip(params, ref_params)):
        check(p.detach(), q.detach(), f"leaf {i}")
        for key in ("exp_avg", "exp_avg_sq", "step"):
            check(opt.state[p][key], ref_opt.state[q][key], f"{key} of leaf {i}")


def _misaligned(shapes, device, seed=0):
    """Leaves whose data starts 4 bytes past a 16-byte boundary."""
    out = []
    for p in _leaves(shapes, device, seed):
        buf = torch.empty(p.numel() + 1, device=device)
        buf[1:].copy_(p.detach().reshape(-1))
        out.append(torch.nn.Parameter(buf[1:].view(p.shape)))
        assert out[-1].data_ptr() % 16 == 4
    return out


def _druglamp2c2p_shapes():
    from druglamp_tpu_torch.config import Config
    from druglamp_tpu_torch.models.registry import build_model

    model = build_model("DrugLAMP2C2P", Config(), generator=torch.Generator().manual_seed(0))
    return [tuple(p.shape) for p in model.parameters()]


@pytest_card
@pytest.mark.parametrize("leaves", ["awkward", "misaligned", "empty", "druglamp2c2p"])
def test_kernel_matches_torch_capturable_adamw(cuda, leaves):
    """20 f32 steps through the kernel against torch's foreach capturable
    AdamW from the same leaves and gradients: parameters, both moments and the
    device step counts within rtol 1e-5 / atol 1e-7; one launch a step.  An
    empty leaf's step count advances as torch's does."""
    shapes = {"awkward": AWKWARD, "misaligned": AWKWARD, "empty": [(0,)] + AWKWARD + [(2, 0)],
              "druglamp2c2p": None}[leaves] or _druglamp2c2p_shapes()
    make = _misaligned if leaves == "misaligned" else _leaves
    params, ref = make(shapes, cuda), _leaves(shapes, cuda)
    if leaves == "druglamp2c2p":
        assert (len(shapes), sum(p.numel() for p in params)) == (236, 14_882_888)
    opt, ref_opt = make_adamw(params), _torch_capturable(ref)
    adamw.reset_launch_counts()
    _run(opt, params, STEPS)
    _run(ref_opt, ref, STEPS, kernel=False)
    torch.cuda.synchronize()
    assert adamw.LAUNCHES == {"adamw": STEPS}
    _assert_same_state(opt, params, ref_opt, ref)
    assert all(opt.state[p]["step"].is_cuda and float(opt.state[p]["step"]) == STEPS
               for p in params)


@pytest_card
def test_kernel_repeats_bit_for_bit(cuda):
    runs = []
    for _ in range(2):
        params = _leaves(AWKWARD + [(1024, 1024)], cuda)
        opt = make_adamw(params)
        _run(opt, params, STEPS)
        runs.append((opt, params))
    torch.cuda.synchronize()
    _assert_same_state(*runs[0], *runs[1], exact=True)


@pytest_card
@pytest.mark.parametrize("writer", ["torch", "kernel", "torch-cpu-steps"])
def test_checkpoint_loaded_mid_run_continues(cuda, writer):
    """10 steps by the ``writer`` (torch's capturable AdamW, as the optimizer
    stepped before the kernel, or the kernel), its state saved as torch saves
    it and loaded on the CPU into a new optimizer, then 10 steps by the other:
    the same as 20 uninterrupted steps of torch's AdamW.  With
    ``torch-cpu-steps`` the saved groups are not capturable, so the loaded
    step counts stay on the CPU until the kernel moves them to the card."""
    kernel_first = writer == "kernel"
    params, ref = _leaves(AWKWARD, cuda), _leaves(AWKWARD, cuda)
    first = make_adamw(params) if kernel_first else _torch_capturable(params)
    _run(first, params, STEPS // 2, kernel=kernel_first)
    buf = io.BytesIO()
    torch.save(first.state_dict(), buf)
    buf.seek(0)
    saved = torch.load(buf, map_location="cpu", weights_only=True)
    if writer == "torch-cpu-steps":
        saved["param_groups"][0]["capturable"] = False
    second = _torch_capturable(params) if kernel_first else make_adamw(params)
    second.load_state_dict(saved)
    if writer == "torch-cpu-steps":
        assert all(second.state[p]["step"].device.type == "cpu" for p in params)
    _run(second, params, STEPS // 2, first=STEPS // 2, kernel=not kernel_first)
    ref_opt = _torch_capturable(ref)
    _run(ref_opt, ref, STEPS, kernel=False)
    torch.cuda.synchronize()
    _assert_same_state(second, params, ref_opt, ref)


@pytest_card
def test_table_is_rebuilt_after_load_state_dict(cuda):
    """``load_state_dict`` of an earlier state gives the optimizer new state
    tensors: the next step builds a new table on them and steps from the
    loaded state, as torch's AdamW does from it."""
    params = _leaves(AWKWARD, cuda)
    opt = make_adamw(params)
    _run(opt, params, 3)
    saved = copy.deepcopy(opt.state_dict())
    start = [p.detach().clone() for p in params]
    _run(opt, params, 3, first=3)
    old = adamw._TABLES[opt]
    opt.load_state_dict(saved)
    for p, s in zip(params, start):
        p.data.copy_(s)
    ref = [torch.nn.Parameter(s.clone()) for s in start]
    ref_opt = _torch_capturable(ref)
    ref_opt.load_state_dict(copy.deepcopy(saved))
    _run(opt, params, 3, first=3)
    _run(ref_opt, ref, 3, first=3, kernel=False)
    torch.cuda.synchronize()
    assert adamw._TABLES[opt].key != old.key
    _assert_same_state(opt, params, ref_opt, ref)


@pytest_card
@pytest.mark.parametrize("bad", ["bf16", "non-contiguous", "cpu"])
def test_kernel_refuses_leaves_it_does_not_take(cuda, bad):
    params = _leaves([(4, 6), (5,)], cuda)
    if bad == "bf16":
        params[1] = torch.nn.Parameter(params[1].detach().bfloat16())
    elif bad == "non-contiguous":
        params[0] = torch.nn.Parameter(params[0].detach().t())
    else:
        params[1] = torch.nn.Parameter(params[1].detach().cpu())
    for p in params:
        p.grad = torch.zeros_like(p)
    with pytest.raises(ValueError, match="AdamW kernel"):
        apply_optimizer(make_adamw(params), 1e-3)


@pytest_card
def test_full_gate_step_issues_one_adamw_launch_an_optimizer(cuda, monkeypatch):
    """One bf16 full-gate step of DrugLAMP2C2P (three AdamWs): the kernel
    launched once an optimizer, and, profiled, the kernels launched inside
    the ``druglamp.optimizer.*`` ranges: 3 through the kernel, against
    torch's foreach path (the same step with ``opt.step()``) which issues
    hundreds an optimizer; the rest of the step unchanged."""
    from torch.profiler import ProfilerActivity, profile

    from druglamp_tpu_torch.config import Config
    from druglamp_tpu_torch.data.encoding import compact_batch
    from druglamp_tpu_torch.data.loader import build_cm_arrays
    from druglamp_tpu_torch.models.registry import build_model
    from druglamp_tpu_torch.train.state import TrainState
    from druglamp_tpu_torch.train.steps import make_train_step
    from druglamp_tpu_torch.utils.synthetic import make_batch

    monkeypatch.setenv("DRUGLAMP_PACKED_GCN", "1")
    cfg = Config()
    host = make_batch(cfg, 16, seed=0, n_drug_feature=384, n_prot_feature=640)
    batch = compact_batch(host, (host["d_fill"] == 0).sum(1))
    t = np.arange(16)
    batch["labels"] = ((t % 3 == 0) & (t % 5 != 4)).astype(np.float32)
    cm = build_cm_arrays(t % 5, t % 7, batch["labels"])
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in batch.items()}
    batch["cm"] = {k: torch.from_numpy(v).to(cuda) for k, v in cm.items()}

    def launches(kernel: bool):
        model = build_model("DrugLAMP2C2P", cfg, generator=torch.Generator().manual_seed(0))
        step = make_train_step(model, True, True, calibrate=True)
        state = TrainState.create(model, True, True)
        gen = torch.Generator(device=cuda).manual_seed(0)
        with monkeypatch.context() as mp:
            if not kernel:
                mp.setattr(adamw, "step", lambda opt, lr: opt.step())
            out = step(state, batch, gen, 1e-4, 3e-5, 3e-5, 0.5, 1e-3)    # the state created
            adamw.reset_launch_counts()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                step(state, batch, gen, 1e-4, 3e-5, 3e-5, 0.5, out.cm_weight)
                torch.cuda.synchronize()
        return _kernels_by_range(prof), dict(adamw.LAUNCHES)

    (opt_k, rest_k, names), counted = launches(True)
    (opt_t, rest_t, _), _ = launches(False)
    assert counted == {"adamw": 3}
    assert opt_k == 3 and all("adamw" in n for n in names), names
    assert opt_t > 100 * 3
    assert rest_k == rest_t
    print(f"optimizer-range kernels: {opt_t} (torch foreach, capturable) -> {opt_k}; "
          f"the rest of the step {rest_k}")


def _kernels_by_range(prof):
    """(kernels launched inside ``druglamp.optimizer.*`` host ranges, kernels
    launched elsewhere, the optimizer kernels' names) of a profiled step: each
    kernel placed by the host time of the CUDA API call that launched it
    (matched by correlation id); copies and fills left out."""
    cpu = torch.autograd.DeviceType.CPU
    raw = list(prof.profiler.kineto_results.events())
    ranges = [(e.start_ns(), e.end_ns()) for e in raw
              if e.device_type() == cpu and e.name().startswith("druglamp.optimizer.")]
    launched = {e.correlation_id(): e.start_ns() for e in raw
                if e.device_type() == cpu and not e.is_user_annotation()
                and e.name().startswith("cu")}
    inside, outside, names = 0, 0, []
    for e in raw:
        if (e.device_type() == cpu or e.is_user_annotation()
                or e.name().startswith(("Memcpy", "Memset")) or e.correlation_id() not in launched):
            continue
        at = launched[e.correlation_id()]
        if any(a <= at <= b for a, b in ranges):
            inside += 1
            names.append(e.name())
        else:
            outside += 1
    return inside, outside, names


def test_state_module_keeps_the_reference_settings():
    """``train/state.py``'s optimizers are built with the settings the kernel
    compiles in, and the kernel refuses an optimizer built with others."""
    opt = make_adamw(_leaves([(2,)]))
    group = opt.param_groups[0]
    assert (state_mod.B1, state_mod.B2, state_mod.EPS, state_mod.WEIGHT_DECAY) == (
        adamw.B1, adamw.B2, adamw.EPS, adamw.WEIGHT_DECAY)
    assert (tuple(group["betas"]), group["eps"], group["weight_decay"]) == (
        (adamw.B1, adamw.B2), adamw.EPS, adamw.WEIGHT_DECAY)
    group["weight_decay"] = 0.02
    with pytest.raises(ValueError, match="weight decay"):
        adamw._build(opt, adamw._params(opt))
