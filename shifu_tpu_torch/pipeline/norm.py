"""`norm` step: materialize the normalized and binned training planes —
the port of ``shifu_tpu.pipeline.norm`` (reference
``NormalizeModelProcessor.java:48,67-95``, ``Normalize.pig``,
``NormalizeUDF``).

Streams the training data through the :class:`DatasetTransformer` and
writes npz shards of (x float32, y, w) to ``tmp/NormalizedData`` and the
clean plane to ``tmp/CleanedData``: by default (``shifu.norm.wireOnly``)
as the flat wire plane ``train`` reads, in the narrowest bins dtype, else
(and always under ``-shuffle``) as npz shards of (bins, y, w).  Each plane
gets a ``schema.json``.  ``-shuffle`` permutes the rows across shards with
a fixed seed (reference ``MapReduceShuffle``).

The step runs on the host, as the reference's does: the transform is numpy
f64 (``ops/normalize.py``, ``ops/binning.ColumnBinner``), so both planes
are the reference's bit for bit.

Crash consistency: every shard commits atomically and lands a record in
the step journal (``tmp/journal/NORMALIZE.json``).  A re-run after a crash
verifies the committed prefix against the journal (sizes must match),
adopts the wire plane's committed prefix (truncating a torn tail) and
resumes at the first uncommitted shard; the replay is deterministic
(per-chunk sampling seeds), so the resumed bytes equal an uninterrupted
run's.

The parse goes through the columnar raw cache (``data/rawcache.py``)
under ``tmp/RawCache``: after ``stats`` wrote it, norm reads memmaps of
the parsed columns and touches no text (``-Dshifu.ingest.rawCache=false``
parses again, with the same arrays).

With telemetry on, the binned chunks feed the streaming drift monitor
(``telemetry/drift.json``) and the step counts ``norm.rows``.  Not
ported: the reference's fault-injection sites of this step (ROADMAP Queue
1 item 13), which fire only when faults are armed.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
import time
from typing import Dict, List, Optional

import numpy as np

from .. import faults, obs
from ..config import environment
from ..config.validator import ModelStep
from ..data.parsepool import iter_extracted
from ..data.purifier import sample_mask
from ..data.reader import DataSource
from ..data.shards import bins_wire_dtype
from ..data.spill import WireWriter, wire_dir
from ..data.transform import DatasetTransformer
from ..ioutil import atomic_savez, atomic_write_json
from .processor import BasicProcessor

log = logging.getLogger(__name__)

SHARD_ROWS = 1 << 18
WIRE_KEYS = ("bins", "y", "w")


class NormalizeProcessor(BasicProcessor):
    step = ModelStep.NORMALIZE

    def __init__(self, model_set_dir: str = ".",
                 params: Optional[dict] = None, device="cpu"):
        super().__init__(model_set_dir, params, device)

    def process(self) -> int:
        mc = self.model_config
        transformer = DatasetTransformer(mc, self.column_configs)
        source = DataSource(self._abs(mc.dataSet.dataPath),
                            mc.dataSet.dataDelimiter,
                            header_path=self._abs(mc.dataSet.headerPath),
                            header_delimiter=mc.dataSet.headerDelimiter)
        norm_dir, clean_dir = self.paths.norm_dir, self.paths.clean_dir

        # -shuffle rewrites every shard at the end, so it neither resumes
        # nor writes the wire plane (npz clean shards instead)
        do_shuffle = bool(self.params.get("shuffle"))
        wire_only = environment.get_bool("shifu.norm.wireOnly", True) \
            and not do_shuffle
        sig = self._signature(source, wire_only)
        committed: Dict[int, dict] = {}
        for name, meta in self.journal.arm(sig, resume=not do_shuffle
                                           ).items():
            if name.startswith("shard-"):
                committed[int(name.split("-", 1)[1])] = meta
        resume_upto = 0                 # first uncommitted shard index
        while resume_upto in committed:
            resume_upto += 1

        # the narrowest dtype the bin space fits (uint8 for <= 256 bins):
        # the dtype the trainers ship to the device
        n_bins = max((c.num_bins() + 1 for c in transformer.columns),
                     default=2)
        self._bins_dtype = bins_wire_dtype(n_bins)
        wire_sig = {"norm": hashlib.md5(
            json.dumps(sig, sort_keys=True).encode()).hexdigest()}
        wdir = wire_dir(clean_dir, WIRE_KEYS)
        wire_dtypes = {"bins": self._bins_dtype,
                       "y": np.dtype(np.float32), "w": np.dtype(np.float32)}
        wire_trailing = {"bins": (len(transformer.columns),),
                         "y": (), "w": ()}
        wire: Optional[WireWriter] = None
        if wire_only and resume_upto:
            # adopt the committed wire prefix; an unusable one voids the
            # resume, so no journal record points at missing wire rows
            wire = WireWriter.resume(wdir, WIRE_KEYS, wire_dtypes,
                                     wire_trailing, wire_sig, resume_upto)
            if wire is None:
                log.warning("norm: journal offers %d committed shard(s) "
                            "but the wire plane does not cover them — "
                            "restarting from shard 0", resume_upto)
                committed, resume_upto = {}, 0
        keep_names = {f"part-{k:05d}.npz" for k in range(resume_upto)}
        for d in (norm_dir, clean_dir):
            os.makedirs(d, exist_ok=True)
            for f in os.listdir(d):
                if f in keep_names:
                    continue
                p = os.path.join(d, f)
                if wire is not None and d == clean_dir \
                        and f == ".spill_cache":
                    # the adopted wire prefix lives here: clear only its
                    # siblings
                    for g in os.listdir(p):
                        gp = os.path.join(p, g)
                        if gp != wdir:
                            shutil.rmtree(gp) if os.path.isdir(gp) \
                                else os.remove(gp)
                    continue
                shutil.rmtree(p) if os.path.isdir(p) else os.remove(p)
        if wire_only and wire is None:
            wire = WireWriter(wdir, WIRE_KEYS, wire_dtypes, wire_trailing,
                              wire_sig)
        if resume_upto:
            obs.counter("norm.resumed_shards").inc(resume_upto)
            log.info("norm: resuming — %d committed shard(s) verified, "
                     "restart at shard %d", resume_upto, resume_upto)

        self._shard_counts: List[int] = []
        self._resume_upto = resume_upto
        self._committed = committed
        self._wire = wire

        rate = mc.normalize.sampleRate
        neg_only = mc.normalize.sampleNegOnly
        shard, rows, seen, total_out = 0, 0, 0, 0
        bufx, bufb, bufy, bufw = [], [], [], []
        # streaming drift monitor (obs/drift): per-column PSI of this
        # run's binned windows against the binning snapshot in
        # ColumnConfig; None (no per-chunk cost) when telemetry is off
        drift = obs.start_drift_monitor(transformer.columns)
        t0 = time.perf_counter()
        with self.phase("transform") as ph:
            for _, ex in iter_extracted(
                    source, transformer.extractor,
                    cache_root=self.paths.raw_cache_dir):
                tc = transformer.transform_extracted(ex)
                if tc.n == 0:
                    continue
                if drift is not None:
                    drift.update(tc.bins)
                keep = sample_mask(tc.n, rate, seed=seen, neg_only=neg_only,
                                   targets=tc.target)
                seen += tc.n
                bufx.append(tc.x[keep]); bufb.append(tc.bins[keep])
                bufy.append(tc.target[keep]); bufw.append(tc.weight[keep])
                rows += int(keep.sum())
                total_out += int(keep.sum())
                if rows >= SHARD_ROWS:
                    self._flush(norm_dir, clean_dir, shard, bufx, bufb,
                                bufy, bufw)
                    shard += 1
                    rows = 0
                    bufx, bufb, bufy, bufw = [], [], [], []
            if rows:
                self._flush(norm_dir, clean_dir, shard, bufx, bufb, bufy,
                            bufw)
                shard += 1
            ph.set(rows=total_out)
        if wire is not None:
            wire.finish()
        if do_shuffle:
            with self.phase("shuffle"):
                self._shard_counts = self._shuffle(norm_dir) \
                    or self._shard_counts
                self._shuffle(clean_dir)
                self._recommit_shuffled(norm_dir, clean_dir,
                                        self._shard_counts)
        obs.counter("norm.rows").inc(total_out)
        obs.gauge("norm.shards").set(shard)
        obs.gauge("norm.rows_per_sec").set(
            total_out / max(time.perf_counter() - t0, 1e-9))
        if drift is not None:
            drift.emit(path=self.paths.drift_path)
        schema = {
            "outputNames": transformer.output_names,
            "columnNums": [c.columnNum for c in transformer.columns],
            "columnNames": [c.columnName for c in transformer.columns],
            "normType": mc.normalize.normType.name,
            "numShards": shard,
            "numRows": total_out,
            "shardRows": list(self._shard_counts),
            "binsDtype": np.dtype(self._bins_dtype).name,
            "width": transformer.width,
        }
        atomic_write_json(os.path.join(norm_dir, "schema.json"), schema)
        clean_schema = dict(schema)
        if wire is not None:
            # the signature pins schema <-> wire manifest
            clean_schema.update(wire=True, wireKeys=list(WIRE_KEYS),
                                wireSignature=wire_sig)
        atomic_write_json(os.path.join(clean_dir, "schema.json"),
                          clean_schema)
        log.info("norm: %d shards, %d input cols -> %d features",
                 shard, len(transformer.columns), transformer.width)
        return 0

    def _signature(self, source: DataSource, wire_only: bool = False) -> dict:
        """Identity of the run's inputs and transform config: a resume is
        valid only when the replayed stream gives the same bytes."""
        mc = self.model_config
        files = []
        for f in source.files:
            st = os.stat(f)
            files.append([os.path.basename(f), st.st_size, st.st_mtime_ns])
        try:
            with open(self.paths.column_config_path, "rb") as f:
                cc_hash = hashlib.md5(f.read()).hexdigest()
        except OSError:
            cc_hash = None
        return {"files": files, "columnConfig": cc_hash,
                "normType": mc.normalize.normType.name,
                "sampleRate": mc.normalize.sampleRate,
                "sampleNegOnly": bool(mc.normalize.sampleNegOnly),
                "shardRows": SHARD_ROWS,
                # npz-committed shards cannot resume into a wire run (or
                # the reverse): a mode flip resets the journal
                "wireOnly": bool(wire_only)}

    def _flush(self, norm_dir: str, clean_dir: str, shard: int,
               bufx: List[np.ndarray], bufb, bufy, bufw) -> None:
        x = np.concatenate(bufx)
        b = np.concatenate(bufb)
        y = np.concatenate(bufy)
        w = np.concatenate(bufw)
        np_path = os.path.join(norm_dir, f"part-{shard:05d}.npz")
        cl_path = os.path.join(clean_dir, f"part-{shard:05d}.npz")
        prev = self._committed.get(shard) if shard < self._resume_upto \
            else None
        if prev is not None and int(prev.get("rows", -1)) == len(y):
            # a verified shard of the interrupted run: the deterministic
            # replay gave the same rows, so its bytes are on disk already
            self._shard_counts.append(int(len(y)))
            if self._wire is not None and self._wire.n_shards <= shard:
                # an earlier divergence truncated the wire behind the
                # journal: land this committed shard's rows again
                faults.fire("norm", "wire", shard, path=cl_path)
                self._wire.append({"bins": b.astype(self._bins_dtype),
                                   "y": y, "w": w})
            return
        if prev is not None:
            log.warning("norm resume: shard %d row count diverged "
                        "(journal %s vs replay %d) — rewriting",
                        shard, prev.get("rows"), len(y))
        faults.fire("norm", "shard", shard, path=np_path)
        atomic_savez(np_path, x=x, y=y, w=w)
        if self._wire is not None:
            if self._wire.n_shards > shard:
                # a diverged resumed shard: it and everything after re-run
                self._wire.truncate_to(shard)
            faults.fire("norm", "wire", shard, path=cl_path)
            self._wire.append({"bins": b.astype(self._bins_dtype),
                               "y": y, "w": w})
            files = [np_path]
        else:
            atomic_savez(cl_path, bins=b.astype(self._bins_dtype), y=y, w=w)
            files = [np_path, cl_path]
        self.journal.commit_item(f"shard-{shard:05d}",
                                 files=files, rows=int(len(y)))
        self._shard_counts.append(int(len(y)))

    def _shuffle(self, d: str) -> Optional[List[int]]:
        """Load every shard, permute the rows globally, rewrite (reference
        ``core/shuffle/MapReduceShuffle.java``).  Returns the rewritten
        per-shard row counts (``array_split`` re-balances them)."""
        files = sorted(f for f in os.listdir(d) if f.endswith(".npz"))
        if not files:
            return None
        datas = [dict(np.load(os.path.join(d, f))) for f in files]
        keys = datas[0].keys()
        merged = {k: np.concatenate([dd[k] for dd in datas]) for k in keys}
        n = len(next(iter(merged.values())))
        perm = np.random.default_rng(12345).permutation(n)
        splits = np.array_split(np.arange(n), len(files))
        for i, f in enumerate(files):
            sel = perm[splits[i]]
            atomic_savez(os.path.join(d, f),
                         **{k: merged[k][sel] for k in keys})
        return [len(s) for s in splits]

    def _recommit_shuffled(self, norm_dir: str, clean_dir: str,
                           counts: List[int]) -> None:
        """The shuffle rewrote every shard: pin the journal records to the
        shuffled sizes so downstream verification stays truthful."""
        for k, rows in enumerate(counts):
            name = f"part-{k:05d}.npz"
            self.journal.commit_item(
                f"shard-{k:05d}",
                files=[os.path.join(norm_dir, name),
                       os.path.join(clean_dir, name)],
                rows=int(rows), shuffled=True)
