"""The width bounds of the port's ``connectivity.network_sds`` against the
JAX package's and against instantiated tables: equal where every source's
synapses spread evenly, at least the built widths everywhere, where the
reference's fall short (ROADMAP §3 item 5).
"""

import pytest

torch = pytest.importorskip("torch")

from repro.core import connectivity as jconn  # noqa: E402
from repro.core.areas import mam_benchmark_spec as jax_bench_spec  # noqa: E402
from repro.core.areas import mam_spec as jax_mam_spec  # noqa: E402
from repro_torch.core import connectivity as tconn  # noqa: E402
from repro_torch.core.areas import mam_benchmark_spec, mam_spec  # noqa: E402
from test_torch_dryrun import _same_stand_ins  # noqa: E402


def test_width_bounds_equal_the_references_where_synapses_spread_evenly():
    """Equal areas without ghost rows: a source's outgoing tables and its
    window-cut and lane-cut slices expect K, K / S and K / lanes synapses,
    the reference's rule, so the widths are the reference's; under the
    group cut a source's inter synapses land only in the other areas, so a
    group of them holds more than 1 / S and the port's width is wider."""
    jspec = jax_bench_spec(n_areas=4, n_per_area=48, k_intra=8, k_inter=8)
    tspec = mam_benchmark_spec(n_areas=4, n_per_area=48, k_intra=8, k_inter=8)
    for kw in (dict(), dict(inter_shards=4, inter_shard_mode="window"),
               dict(inter_shards=8, inter_shard_mode="window"), dict(subgroup=4)):
        kw = dict(size_multiple=8, outgoing=True, **kw)
        assert _same_stand_ins(jconn.network_sds(jspec, **kw), tconn.network_sds(tspec, **kw))
    kw = dict(size_multiple=8, outgoing=True, inter_shards=2, subgroup=2)
    jnet, tnet = jconn.network_sds(jspec, **kw), tconn.network_sds(tspec, **kw)
    assert tnet.tgt_inter_in.shape[-1] > jnet.tgt_inter_in.shape[-1]


# (spec, inbound cut: shards, mode, lanes, whether the reference's bounds
# fall short). The first is the card's [dryrun] (b) cut (4 x 130,000, K
# 3000) at a size a CPU builds in a second.
BRACKET_CASES = {
    "bench 4 x 2048, K 1024, 2 groups x 2 lanes": (
        lambda m: m(n_areas=4, n_per_area=2048, k_intra=1024, k_inter=1024), 2, "group", 2,
        True),
    "bench 4 x 64, the verify row's cut": (
        lambda m: m(n_areas=4, n_per_area=64, k_intra=8, k_inter=12), 2, "group", 2, False),
    "mam x0.01, 16 groups x 2 lanes": (lambda m: m(scale=0.01), 16, "group", 2, True),
    "mam x0.01, window cut over 8": (lambda m: m(scale=0.01), 8, "window", 1, True),
}


@pytest.mark.parametrize("case", list(BRACKET_CASES))
def test_width_bounds_bracket_instantiated_tables(case):
    """Every bound width of the port's stand-in is at least the width the
    build gives, for the outgoing tables, the inbound slices and the lane
    intra cut. The reference's fall short where a source's synapses do not
    spread evenly once K outgrows their slack: the MAM's unequal areas
    (ghost rows draw too) and a few areas a group."""
    make, shards, mode, sub, ref_short = BRACKET_CASES[case]
    tspec = make(mam_spec if "mam" in case else mam_benchmark_spec)
    jspec = make(jax_mam_spec if "mam" in case else jax_bench_spec)
    net = tconn.build_network(tspec, seed=12, size_multiple=8, outgoing=True, device="cpu")
    cut = tconn.shard_inter_tables(net, shards, mode=mode, subgroup=sub)
    got = {"tgt_intra": net.tgt_intra.shape[-1], "tgt_inter": net.tgt_inter.shape[-1],
           "tgt_inter_in": cut.tgt_inter_in.shape[-1]}
    if sub > 1:
        got["lane tgt_intra"] = tconn.slice_intra_tables(net, sub).tgt_intra.shape[-1]
    short = []
    for kw in (dict(), dict(inter_shards=shards, inter_shard_mode=mode, subgroup=sub)):
        kw = dict(size_multiple=8, outgoing=True, **kw)
        t, j = tconn.network_sds(tspec, **kw), jconn.network_sds(jspec, **kw)
        for name in ("tgt_intra", "tgt_inter", "tgt_inter_in"):
            if getattr(t, name) is None:
                continue
            key = "lane tgt_intra" if name == "tgt_intra" and kw.get("subgroup", 1) > 1 else name
            assert getattr(t, name).shape[-1] >= got[key], (key, got)
            if getattr(j, name).shape[-1] < got[key]:
                short.append(key)
    assert bool(short) == ref_short, (short, got)


def test_network_sds_refuses_a_window_cut_with_lanes():
    with pytest.raises(ValueError, match="subgroup slicing applies to the 'group' mode"):
        tconn.network_sds(mam_spec(scale=1.0), outgoing=True, inter_shards=2,
                          inter_shard_mode="window", subgroup=2)
    with pytest.raises(ValueError, match="subgroup slicing applies to the 'group' mode"):
        jconn.network_sds(jax_mam_spec(scale=1.0), outgoing=True, inter_shards=2,
                          inter_shard_mode="window", subgroup=2)
