"""Association-pack jobs (org.avenir.association.*): the port of
``avenir_tpu/cli/association_jobs.py``.

Config-key namespaces follow the reference: fia.* (FrequentItemsApriori,
sample resource/fit.properties), iim.* (InfrequentItemMarker), arm.*
(AssociationRuleMiner).  In a joined run every process computes the
global level and writes it; the counters of global results count on
process 0 only (the others add 0 so the key set stays aligned for the
counter sum), as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

from ..core import artifacts
from ..core.config import Config
from ..core.metrics import Counters
from ..parallel.distributed import process_index
from ..runtime import resolve_device
from ..utils.tracing import LayerProfile, layer
from .jobs import _splitter, register


def _read_rows(path: str, delim_regex: str):
    split = _splitter(delim_regex)
    return [split(line) for line in map(str.strip,
                                        artifacts.read_text_input(path))
            if line]


@register("org.avenir.association.FrequentItemsApriori",
          "frequentItemsApriori", dist="sharded")
def frequent_items_apriori(cfg: Config, in_path: str, out_path: str,
                           profile: Optional[LayerProfile] = None
                           ) -> Counters:
    """One Apriori level.  Keys: fia.item.set.length, fia.tans.id.ord,
    fia.skip.field.count, fia.emit.trans.id, fia.trans.id.output,
    fia.support.threshold, fia.total.tans.count, fia.item.set.file.path
    (level > 1), fia.infreq.item.marker."""
    from ..association import itemsets as IT
    dev = resolve_device()
    counters = Counters()
    length = cfg.must_get_int("fia.item.set.length",
                              "missing item set length")
    trans_ord = cfg.must_get_int("fia.tans.id.ord",
                                 "missing transaction id ordinal")
    skip = cfg.get_int("fia.skip.field.count", 1)
    emit_tid = cfg.get_boolean("fia.emit.trans.id", True)
    tid_out = cfg.get_boolean("fia.trans.id.output", True)
    threshold = cfg.must_get_float("fia.support.threshold",
                                   "missing support threshold")
    total = cfg.must_get_int("fia.total.tans.count",
                             "missing total transaction count")
    marker = cfg.get("fia.infreq.item.marker")
    with layer(profile, "parse"):
        rows = _read_rows(in_path, cfg.field_delim_regex)
        transactions = IT.read_transactions(rows, trans_ord, skip, marker)
    prior = None
    if length > 1:
        prior = IT.parse_itemset_lines(
            artifacts.read_text_input(
                cfg.must_get("fia.item.set.file.path",
                             "missing item set file")),
            length - 1, emit_tid,
            cfg.get("fia.itemset.delim", cfg.field_delim_out))
    level = IT.apriori_level(transactions, length, total, threshold, prior,
                             emit_tid, collect_trans_ids=emit_tid and tid_out,
                             device=dev, profile=profile)
    with layer(profile, "write"):
        artifacts.write_text_output(
            out_path, IT.format_itemset_lines(level, emit_tid, tid_out,
                                              cfg.field_delim_out))
    counters.increment("Apriori", "frequentItemSets",
                       len(level) if process_index() == 0 else 0)
    counters.increment("Apriori", "transactions", len(transactions))
    return counters


@register("org.avenir.association.InfrequentItemMarker",
          "infrequentItemMarker", dist="map")
def infrequent_item_marker(cfg: Config, in_path: str, out_path: str
                           ) -> Counters:
    """Map-only infrequent-item masking.  Keys: iim.item.set.file.path
    (level-1 itemsets), iim.item.set.length (must be 1),
    iim.contains.trans.id, iim.skip.field.count, iim.infreq.item.marker,
    iim.itemset.delim."""
    from ..association import itemsets as IT
    resolve_device()
    counters = Counters()
    length = cfg.must_get_int("iim.item.set.length",
                              "missing item set length")
    if length != 1:
        raise ValueError("expecting item set of length 1")
    contains_tid = cfg.get_boolean("iim.contains.trans.id", True)
    skip = cfg.get_int("iim.skip.field.count", 1)
    marker = cfg.get("iim.infreq.item.marker", "*")
    itemsets = IT.parse_itemset_lines(
        artifacts.read_text_input(
            cfg.must_get("iim.item.set.file.path", "missing item set file")),
        1, contains_tid, cfg.get("iim.itemset.delim", ","))
    freq = [s.items[0] for s in itemsets]
    rows = _read_rows(in_path, cfg.get("iim.field.delim.regex",
                                       cfg.field_delim_regex))
    marked = IT.mark_infrequent(rows, freq, marker, skip)
    delim_out = cfg.get("iim.field.delim.out", cfg.field_delim_out)
    artifacts.write_text_output(out_path,
                                [delim_out.join(r) for r in marked],
                                role="m")
    counters.increment("Apriori", "frequentItems",
                       len(freq) if process_index() == 0 else 0)
    return counters


@register("org.avenir.association.AssociationRuleMiner",
          "associationRuleMiner", dist="gather")
def association_rule_miner(cfg: Config, in_path: str, out_path: str
                           ) -> Counters:
    """Rule mining from frequent itemsets.  Keys: arm.conf.threshold,
    arm.max.ante.size, arm.input.has.count (count-mode Apriori input),
    arm.input.itemset.length (trans-id-mode input: the first N fields are
    items), arm.output.confidence (the JAX package's extension)."""
    from ..association import rules as RU
    resolve_device()
    counters = Counters()
    threshold = cfg.must_get_float("arm.conf.threshold",
                                   "missing confidence threshold")
    max_ante = cfg.get_int("arm.max.ante.size", 3)
    frequent = RU.parse_frequent_lines(
        artifacts.read_text_input(in_path), cfg.field_delim_out,
        cfg.get_boolean("arm.input.has.count", False),
        cfg.get_int("arm.input.itemset.length"))
    lines = RU.mine_rules(frequent, threshold, max_ante,
                          cfg.field_delim_out,
                          cfg.get_boolean("arm.output.confidence", False))
    artifacts.write_text_output(out_path, lines)
    counters.increment("Apriori", "rules", len(lines))
    return counters
