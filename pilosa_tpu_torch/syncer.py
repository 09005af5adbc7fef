"""Anti-entropy: periodic convergence of attrs and fragment data.

Reference analog: HolderSyncer (holder.go:364-562) + FragmentSyncer
(fragment.go:1300-1481).  For every index: sync column attrs with every
peer; for every frame: sync row attrs; for every view/owned slice:
compare per-block checksums against replica peers, pull differing blocks,
majority-vote merge (fragment.merge_block), and push set/clear diffs back
to each peer as SetBit/ClearBit PQL.

Peer failures during a sync pass are SKIPPED (a dead replica must not
break anti-entropy for the live pair) but never silently: every skip
counts ``syncer.peer_errors`` (tagged ``node:<host>``) and updates the
``syncer.last_peer_error`` string at /debug/vars, so a steady anti-
entropy stall (bad peer address, auth wall, wedged node) is visible on
a dashboard instead of only as slowly diverging replicas.
"""

from __future__ import annotations


class HolderSyncer:
    def __init__(self, holder, cluster, host: str, client_factory, stats=None):
        from pilosa_tpu_torch.stats import NOP_STATS

        self.holder = holder
        self.cluster = cluster
        self.host = host
        self.client_factory = client_factory
        self.stats = stats if stats is not None else NOP_STATS
        # Process-lifetime totals (tests, embedders without an expvar
        # sink); the tagged per-node counters live in the stats client.
        self.stat_peer_errors = 0
        self.last_peer_error = ""

    def _peers(self):
        return [n for n in self.cluster.nodes if n.host != self.host]

    def _note_peer_error(self, host: str, where: str, e: BaseException) -> None:
        """One skipped peer interaction: count it (node-tagged) and keep
        the last error string visible at /debug/vars."""
        self.stat_peer_errors += 1
        self.last_peer_error = f"{host} {where}: {e}"
        self.stats.with_tags(f"node:{host}").count("syncer.peer_errors")
        self.stats.set("syncer.last_peer_error", self.last_peer_error)

    # -- attrs (holder.go:385-470) ----------------------------------------

    def sync_index_attrs(self, index_name: str) -> None:
        idx = self.holder.index(index_name)
        if idx is None:
            return
        for node in self._peers():
            client = self.client_factory(node.host)
            try:
                missing = client.column_attr_diff(index_name, idx.column_attr_store.blocks())
            except Exception as e:  # noqa: BLE001 — skip the peer, visibly
                self._note_peer_error(node.host, "column-attr diff", e)
                continue
            for id, attrs in missing.items():
                idx.column_attr_store.set_attrs(id, attrs)

    def sync_frame_attrs(self, index_name: str, frame_name: str) -> None:
        frame = self.holder.frame(index_name, frame_name)
        if frame is None:
            return
        for node in self._peers():
            client = self.client_factory(node.host)
            try:
                missing = client.row_attr_diff(index_name, frame_name, frame.row_attr_store.blocks())
            except Exception as e:  # noqa: BLE001 — skip the peer, visibly
                self._note_peer_error(node.host, "row-attr diff", e)
                continue
            for id, attrs in missing.items():
                frame.row_attr_store.set_attrs(id, attrs)

    # -- fragments (fragment.go:1300-1481) ---------------------------------

    def sync_fragment(self, index_name: str, frame_name: str, view_name: str, slice_i: int) -> None:
        frag = self.holder.fragment(index_name, frame_name, view_name, slice_i)
        if frag is None:
            return
        replicas = [
            n for n in self.cluster.fragment_nodes(index_name, slice_i) if n.host != self.host
        ]
        if not replicas:
            return

        local_blocks = dict(frag.blocks())
        peer_blocks: list[tuple[object, dict[int, bytes]]] = []
        for node in replicas:
            client = self.client_factory(node.host)
            try:
                peer_blocks.append(
                    (node, dict(client.fragment_blocks(index_name, frame_name, view_name, slice_i)))
                )
            except Exception as e:  # noqa: BLE001 — skip the peer, visibly
                self._note_peer_error(node.host, "fragment blocks", e)
                continue

        # Blocks differing on any replica (or missing somewhere).
        all_ids = set(local_blocks)
        for _, blocks in peer_blocks:
            all_ids.update(blocks)
        dirty = [
            bid
            for bid in sorted(all_ids)
            if any(blocks.get(bid) != local_blocks.get(bid) for _, blocks in peer_blocks)
        ]

        for bid in dirty:
            pair_sets = [frag.block_data(bid)]
            nodes = []
            for node, _ in peer_blocks:
                client = self.client_factory(node.host)
                try:
                    pair_sets.append(
                        client.block_data(index_name, frame_name, view_name, slice_i, bid)
                    )
                    nodes.append(node)
                except Exception as e:  # noqa: BLE001 — skip the peer, visibly
                    self._note_peer_error(node.host, "block data", e)
                    continue
            diffs = frag.merge_block(bid, pair_sets)
            # Push each peer its converging diff straight at the fragment
            # (view- and label-agnostic; the reference's PQL push
            # fragment.go:1403-1481 re-derives routing on the peer, which
            # breaks for inverse/time views).
            for node, diff in zip(nodes, diffs[1:]):
                (set_rows, set_cols), (clear_rows, clear_cols) = diff
                if not len(set_rows) and not len(clear_rows):
                    continue
                client = self.client_factory(node.host)
                try:
                    client.post_block_diff(
                        index_name,
                        frame_name,
                        view_name,
                        slice_i,
                        (set_rows.tolist(), set_cols.tolist()),
                        (clear_rows.tolist(), clear_cols.tolist()),
                    )
                except Exception as e:  # noqa: BLE001 — skip the peer, visibly
                    self._note_peer_error(node.host, "block-diff push", e)
                    continue

    # -- full pass (holder.go:364-384) --------------------------------------

    def sync_holder(self) -> None:
        from pilosa_tpu_torch.core.view import VIEW_INVERSE

        for index_name in list(self.holder.indexes):
            idx = self.holder.index(index_name)
            if idx is None:
                continue
            self.sync_index_attrs(index_name)
            max_slice = idx.max_slice()
            max_inverse = idx.max_inverse_slice()
            for frame_name in list(idx.frames):
                frame = idx.frame(frame_name)
                if frame is None:
                    continue
                self.sync_frame_attrs(index_name, frame_name)
                for view_name in list(frame.views):
                    # Inverse views live in the row-id slice space; their
                    # slice range and placement use the inverse max.
                    is_inverse = view_name.startswith(VIEW_INVERSE)
                    upper = max_inverse if is_inverse else max_slice
                    for slice_i in range(upper + 1):
                        if not self.cluster.owns_fragment(self.host, index_name, slice_i):
                            continue
                        self.sync_fragment(index_name, frame_name, view_name, slice_i)
