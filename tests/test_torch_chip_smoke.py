"""chip_smoke.py's bookkeeping that needs no card: the device time of a
profiler trace, each device event counted once, and the lane cuts the
recorded operands are held and timed at."""

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

_PATH = Path(__file__).resolve().parents[1] / "chip_smoke.py"
_spec = importlib.util.spec_from_file_location("chip_smoke", _PATH)
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def _entry(key, device_type, us):
    return SimpleNamespace(key=key, device_type=device_type, self_device_time_total=us)


def test_device_totals_count_each_device_event_once():
    """A torch op and the kernel it launched both carry the kernel's device
    time (the op as its self device time): only the kernel counts. The
    port's k_* kernels, launched through ctypes, have no op above them."""
    events = [
        _entry("aten::add", CPU, 1000),
        _entry("void at::native::vectorized_elementwise_kernel<4, "
               "at::native::CUDAFunctor_add<int>, std::array<char*, 3ul> >", CUDA, 990),
        _entry("cudaLaunchKernel", CPU, 0),
        _entry("(anonymous namespace)::k_f2mul(int const*, int const*, int*, int)", CUDA, 500),
        _entry("(anonymous namespace)::k_f2mul(int const*, int const*, int*, int)", CUDA, 250),
        _entry("Memcpy HtoD (Pageable -> Device)", CUDA, 10),
    ]
    tot = smoke.device_totals(events)
    assert tot["device_ms"] == pytest.approx(1.75)
    assert tot["device_ms_all_entries"] == pytest.approx(2.75)
    assert tot["glue_ms"] == pytest.approx(1.0)
    assert tot["kernels_ms"] == {"k_f2mul": pytest.approx(0.75)}
    assert smoke.device_totals([events[0]])["device_ms"] == 0


def test_widths_cut_lanes_and_stacks():
    """The standard cuts (1, 2, the record's own lanes, 2 x 128) and the
    extra ones: a lane count the record holds, and a stack (K, S) whose
    lanes repeat where the record is narrower than K x S."""
    full = [torch.arange(3000, dtype=torch.int32).expand(2, 36, 3000)]
    cuts = smoke._widths(full, (1024, 4096, (4, 2048)))
    assert list(cuts) == ["S=1", "S=2", "S=3000", "2x128", "S=1024", "4x2048"]
    assert cuts["S=1024"][0].shape == (2, 36, 1024)
    stack = cuts["4x2048"][0]
    assert stack.shape == (4, 2, 36, 2048)
    assert torch.equal(stack[1, 0, 0], torch.arange(2048, 4096, dtype=torch.int32) % 3000)
    assert smoke._label((4, 2048)) == "4x2048" and smoke._label(2048) == "2048"


def test_torch_ops_count_aten_entries_and_the_outer_ones():
    """The host-side aten:: entries of a trace, and those no other aten::
    op called; device-side entries and other host entries do not count."""
    def ev(name, parent=None, device_type=CPU):
        return SimpleNamespace(name=name, cpu_parent=parent, device_type=device_type)

    where = ev("aten::where")
    stack = ev("aten::stack", ev("launch"))
    events = [where, ev("aten::empty", where), stack, ev("aten::cat", ev("x", stack)),
              ev("cudaLaunchKernel"), ev("aten::add", device_type=CUDA)]
    assert smoke.torch_ops(events) == (4, 2)


def test_launch_pins_fold_each_canonical_into_one_launch():
    """The pins derived from the op-by-op counts: each canon_reduce launch
    is one canonical launch (canonical() in one kernel), canon_reduce
    launches no more; each G1 exact add (a verify's one, an MSM's 90) is
    one add_exact_f1 launch in place of a jac_add_f1, 2 sqr, 6 mul, 2
    canonical and a jac_dbl_f1 (EXACT_ADD), so a verify makes 11 launches
    fewer (1,095 / 1,134 -> 1,084 / 1,123) and an MSM 346 in place of
    1,336; jac_add_f1 joins canon_reduce off every path."""
    for bucket, n in ((128, 38), (1024, 44)):
        got = smoke.verify_launches(bucket)
        assert got["canonical"] == n - 2 and "canon_reduce" not in got
        assert (got["add_exact_f1"], got["sqr"], got["mul"], got["jac_dbl_f1"]) == (1, 1, 11, 1)
        assert "jac_add_f1" not in got
        assert sum(got.values()) == {128: 1095, 1024: 1134}[bucket] - 11
    assert smoke.EXACT_ADD == {"jac_add_f1": 1, "sqr": 2, "mul": 6, "canon_reduce": 2,
                               "jac_dbl_f1": 1}
    assert smoke.PER_MSM == {"add_exact_f1": 90, "jac_dbl_f1": 256}
    assert sum(smoke.PER_MSM.values()) == 346 == 1336 - 90 * (sum(smoke.EXACT_ADD.values()) - 1)
    check = smoke.check_launches()
    assert check["canonical"] == 1 and "canon_reduce" not in check and "add_exact_f1" not in check
    assert set(smoke.KZG_KERNELS) >= {"canonical", "add_exact_f1"}
    assert "sqr" not in smoke.KZG_KERNELS and "sqr" in smoke.BLS_KERNELS
    assert smoke.OFF_PATH == ("canon_reduce", "jac_add_f1")


def test_exact_add_planted_lanes_take_every_case(monkeypatch):
    """The smoke's exact-add operands: each planted lane (EXACT_CASES) takes
    its own case of the select on the plain pieces, at full width and cut
    to one lane, and the five cases are all taken."""
    import numpy as np

    monkeypatch.setattr(smoke, "DEVICE", "cpu")
    args = smoke._inputs(np.random.default_rng(13), (36, 12), "add_exact_f1")
    assert all(smoke.exact_branches(args).values())
    branch = {"dbl": "double", "dbl_rescaled": "double", "neg": "infinity",
              "neg_rescaled": "infinity", "inf_p1": "p2", "inf_p2": "p1", "inf_both": "p2",
              "sum": "sum"}
    assert sorted(branch) == sorted(smoke.EXACT_CASES)
    for i, case in enumerate(smoke.EXACT_CASES):
        got = smoke.exact_branches([a[..., i : i + 1] for a in args])
        assert got == {b: int(b == branch[case]) for b in smoke.EXACT_BRANCHES}
    one = smoke._inputs(np.random.default_rng(14), (36, 1), "add_exact_f1", combos=["neg_rescaled"])
    assert smoke.exact_branches(one)["infinity"] == 1


def test_cooperative_kernels_are_the_programs_kernels():
    """COOP_LIBS (phase 2's `[build]` lines, phase 3's widths) names each
    kernel that runs a cooperative program, by the library that launches
    it, and REDESIGNED is that set: twenty-three, among them f6mul, f12sqr
    and f12mul_034 (tower),
    mul and sqr (fp_mul, one warp per lane element) and the ladder steps
    (ladder, the add's and the doubling's programs in one block), held at
    their paths' widths, mul's stacks in MUL_S, sqr's widths in SQR_S."""
    from lighthouse_tpu_torch.ops.lane import coop, kernels

    names = {n for n, _ in coop.PROGRAMS.values()}
    for chain, parts in coop.CHAINS.items():
        names = (names - set(parts)) | {chain}
    names |= set(coop.LADDERS)
    assert set(smoke.COOP_LIBS) == names and len(names) == 23
    assert {smoke.COOP_LIBS[n] for n in coop.LADDERS} == {"ladder"}
    assert smoke.REDESIGNED == tuple(smoke.COOP_LIBS)
    for name, lib in smoke.COOP_LIBS.items():
        assert kernels.ENTRIES[smoke._op(name).symbol][0] == lib, name
    assert (smoke.COOP_LIBS["f6mul"], smoke.COOP_LIBS["mul"]) == ("tower", "fp_mul")
    assert smoke.COOP_LIBS["sqr"] == "fp_mul"
    assert coop.PER_WARP == {"mul", "sqr"}
    assert smoke.MUL_S == (1, 2, 1024, (12, 1), (2, 1), (2, 1024))
    # sqr at one lane and its one launch a verify, 1 x 128 and 1 x 1,024
    assert smoke.SQR_S == (1, 128, 1024)
    assert smoke.SEEDED_S == {"mul": smoke.MUL_S, "sqr": smoke.SQR_S}
    assert set(smoke.SEEDED_S) <= set(smoke.SEEDED)
    # f12sqr and f12mul_034 (tower) also at the unfused doubling's 128 lanes
    assert smoke.F12_S == (1, 2, 1024, 128)
    assert all(smoke.COOP_LIBS[n] == "tower" for n in smoke.F12_KERNELS)


def test_ladder_operands_and_bound_follow_the_bits(monkeypatch):
    """A ladder step's seeded operands plant LADDER_COMBOS' (bit,
    accumulator at infinity, addend at infinity) on lanes 0.., on every
    element of the stack, the pattern on the rest; its bound counts the
    doubling on every lane element and the add where the bit is set (the
    kernel skips it elsewhere)."""
    import numpy as np

    from lighthouse_tpu_torch.ops.lane import coop

    monkeypatch.setattr(smoke, "DEVICE", "cpu")
    assert len(smoke.LADDER_COMBOS) == 8
    for name in ("ladder_step_f1", "ladder_step_f2"):
        args = smoke._slice4_inputs(np.random.default_rng(16), (2, 36, 12), name,
                                    combos=smoke.LADDER_COMBOS)
        nc = 2 if name.endswith("f2") else 1
        zero = [(z == 0).flatten(-1 - nc, -2).all(-2) for z in (args[2], args[5])]
        for i, (b, a, e) in enumerate(smoke.LADDER_COMBOS):
            assert args[6][:, 0, i].tolist() == [b, b]
            assert zero[0][:, i].tolist() == [bool(a)] * 2
            assert zero[1][:, i].tolist() == [bool(e)] * 2
        assert zero[0][:, 10].all() and zero[1][:, 11].all()  # lanes 10, 11: the pattern's
        c = smoke._ops_counts()
        add, dbl = coop.LADDERS[name][0]
        ones = [*args[:6], torch.ones_like(args[6])]
        assert smoke._work_ops(name, [*args[:6], torch.zeros_like(args[6])]) == c[name]
        assert smoke._work_ops(name, ones) == c[name] + c[add]
        assert smoke._work_ops(name, args) == c[name] + c[add] * float(args[6].double().mean())
        assert c[name] == c[dbl] + 3 * 36 * nc


def test_canonical_and_reduce_light_held_at_their_verify_widths():
    """canonical is held and timed at one lane and at the stacks a
    bucket-1024 verify gives it (2 x 1, 2 x 1,024, 8 x 2,048), reduce_light
    at 2 x 2,048, 6 x 1 and 4,097 lanes, whose last block is ragged.
    canonical is also held on its edges and on the long chains: 21 lanes
    whose offset values land on p * 2^k - 1, p * 2^k and p * 2^k + 1 for k
    = 0 .. 6, then limbs all MASK and all -MASK."""
    import numpy as np

    assert smoke.CANON_S == (1, 2, 1024, (2, 1), (2, 1024), (8, 2048))
    assert smoke.RL_S == ((2, 2048), (6, 1), 4097)
    assert smoke._shape((8, 2048)) == (8, 36, 2048) and smoke._shape(4097) == (36, 4097)
    assert smoke._canonical_edges().shape == (36, 7)
    chains = smoke._canonical_chains()
    assert chains.shape == (36, 23) and chains.dtype == np.int32
    assert (chains[35, :21] == 0).all()
    assert (chains[:, 21] == 2047).all() and (chains[:, 22] == -2047).all()


def test_state_phase_packs_validators_as_the_reference_roots_them():
    """Phase 8's leaves on 5 seeded validators, rooted by the port's plain
    bodies on the CPU: each element root equals the reference's
    Validator.hash_tree_root, the registry's root the reference's
    List(Validator, 2^40) root, each uint64 list's root its List(uint64,
    2^40) root, and the hashlib yardstick of the card's checks agrees."""
    import numpy as np

    from lighthouse_tpu.consensus import ssz, types as T
    from lighthouse_tpu_torch.ops.lane import fp, sha256 as H

    n = 5
    cols = smoke.state_columns(np.random.default_rng(21), n)
    fp.reset_counts()
    roots = smoke.hash_state(smoke.state_to_device(smoke.pack_state(cols), "cpu"), n)
    assert not fp.LAUNCHES and not fp.PLAIN_CUDA_CALLS
    vals = [T.Validator.make(
        pubkey=cols["pubkey"][i].tobytes(),
        withdrawal_credentials=cols["withdrawal_credentials"][i].tobytes(),
        effective_balance=int(cols["effective_balance"][i]), slashed=bool(cols["slashed"][i]),
        **{k: int(cols[k][i]) for k in smoke.EPOCH_FIELDS}) for i in range(n)]
    elems = H.chunks_from_words(roots["element_roots"])
    for i, v in enumerate(vals):
        assert elems[32 * i : 32 * i + 32] == T.Validator.hash_tree_root(v)
        assert smoke.host_validator_root(cols, i) == T.Validator.hash_tree_root(v)
    assert roots["validators"] == ssz.List(T.Validator, 2**40).hash_tree_root(vals)
    for key in ("balances", "inactivity_scores"):
        want = ssz.List(ssz.uint64, 2**40).hash_tree_root([int(x) for x in cols[key]])
        assert roots[key] == want
    assert smoke.host_merkleize([], 8) == ssz.merkleize([], 8)


def test_state_phase_pins_its_launches_and_work():
    """At 2^20 - 5 validators (the registry's first layer and both lists'
    first layers of odd width) hash_state makes 60 launches (the pubkey
    level, the element trees' 3, the registry's 20 levels with more than
    one node, the two lists' 18 each) and 19,922,852 compressions on the
    card, 126 on the host (the zero spines to 2^40 and 2^38 chunks, the
    mix-ins); its operations bound is 1.754 ms at the reference's 2,950 a
    compression and 0.677 ms at the 2,276 a node that SHA-256's definition
    needs on the card; the epoch pass moves 67 bytes a validator."""
    n = smoke.STATE_N
    assert n == 2**20 - 5 and n % 2 == 1 and (n + 3) // 4 % 2 == 1
    assert smoke.state_launches(n) == {"sha256_pairs": 60}
    assert smoke.state_compressions(n) == (19_922_852, 126)
    ms, by = smoke.sha_bound_ms(19_922_852 // 2, 2 * smoke.SHA_OPS)
    assert by == "operations" and round(ms, 3) == 1.754
    assert smoke.SHA_NODE_OPS == 2_276
    ms, by = smoke.sha_bound_ms(19_922_852 // 2, smoke.SHA_NODE_OPS)
    assert by == "operations" and round(ms, 3) == 0.677
    assert smoke.EPOCH_BYTES == 67
    assert smoke.STATE_KERNELS == ("sha256_pairs", "epoch_updates")
    assert smoke.KERNELS["sha256_pairs"][1] == "lighthouse_tpu/ops/lane/sha256.py:150"
    assert smoke.KERNELS["epoch_updates"][1] == "lighthouse_tpu/ops/epoch.py:83"
    assert [label for label, _, _ in smoke.EPOCH_SETS] == ["leak_off", "leak_on", "no_deltas"]
