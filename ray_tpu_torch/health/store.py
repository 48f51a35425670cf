"""Bounded two-tier metric time-series store (the GCS health plane's
storage half).

Processes push CUMULATIVE ``util.metrics`` snapshots
(``snapshot_metrics`` payloads); the store delta-merges them per source
— the same watermark discipline ``merge_metrics_snapshot`` uses, so a
periodic pusher never double-counts and a restarted source never
produces a negative rate — into one cluster-wide series per
(name, tags).

Two tiers per series, both bounded:

* a raw ring (``health_store_raw_points`` newest points) — the recent
  window the SLO engine's fast/slow burn windows and the dashboard's
  Metrics page read;
* downsampled rollups over 10s and 1m buckets
  (``health_store_rollup_buckets`` newest buckets per tier) — rate for
  counters, last/min/max/avg for gauges, rate + p50/p99 for histograms
  — so an hours-long view survives long after the raw ring has turned
  over.

A counter's FIRST observation per source is its baseline, not a delta
(prometheus ``rate()`` semantics): a freshly-registered pusher shipping
an hour of pre-existing counts must not render as a rate spike.

Thread-safe: ingest arrives from the embedded head's pusher thread
(direct sink) and from RPC handlers on the gcs-io loop; queries come
from handlers and tests.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from fnmatch import fnmatchcase
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch.util.metrics import Histogram

ROLLUP_WINDOWS_S = (10.0, 60.0)
RESOLUTIONS = {"raw": None, "10s": 10.0, "1m": 60.0}


def _tags_key(tags: Optional[Dict[str, str]]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in (tags or {}).items()))


class _Series:
    """One (name, tags) series. ``cum`` representation by kind:
    counter -> float; gauge -> float (latest); histogram ->
    (bucket_counts tuple, sum, n). Raw points store the cumulative
    representation at ingest time; windowed deltas subtract two of
    them."""

    __slots__ = ("name", "tags", "kind", "raw", "buckets", "per_source",
                 "cum", "boundaries", "first_t")

    def __init__(self, name: str, tags: Tuple, kind: str,
                 raw_points: int, boundaries: Optional[List[float]] = None):
        self.name = name
        self.tags = tags
        self.kind = kind
        self.raw: deque = deque(maxlen=max(2, raw_points))
        # window_s -> OrderedDict[bucket_start -> agg] (oldest first)
        self.buckets: Dict[float, "OrderedDict[float, Any]"] = {
            w: OrderedDict() for w in ROLLUP_WINDOWS_S}
        self.per_source: Dict[str, Any] = {}
        self.boundaries = list(boundaries or [])
        if kind == "histogram":
            self.cum: Any = ([0] * (len(self.boundaries) + 1), 0.0, 0)
        else:
            self.cum = 0.0
        self.first_t: Optional[float] = None

    # -- ingest ---------------------------------------------------------------

    def add(self, t: float, value: Any, rollup_buckets: int) -> None:
        if self.first_t is None:
            self.first_t = t
        self.raw.append((t, value))
        for w, bk in self.buckets.items():
            start = (t // w) * w
            if self.kind == "gauge":
                agg = bk.get(start)
                if agg is None:
                    bk[start] = [value, value, value, value, 1]
                else:
                    agg[0] = value
                    agg[1] = min(agg[1], value)
                    agg[2] = max(agg[2], value)
                    agg[3] += value
                    agg[4] += 1
            else:
                # counters/histograms: keep the bucket's LAST cumulative
                # value; a bucket's delta is judged against its
                # predecessor at query time
                bk[start] = (t, value)
            while len(bk) > rollup_buckets:
                bk.popitem(last=False)

    # -- reads ----------------------------------------------------------------

    def value_at(self, t: float) -> Optional[Tuple[float, Any]]:
        """Newest (time, cum) at or before `t`: raw ring first, rollup
        buckets (10s tier, then 1m) when `t` predates the ring."""
        best: Optional[Tuple[float, Any]] = None
        for pt, pv in reversed(self.raw):
            if pt <= t:
                best = (pt, pv)
                break
        if best is not None:
            return best
        if self.kind == "gauge":
            return None
        for w in ROLLUP_WINDOWS_S:
            for start in reversed(self.buckets[w]):
                bt, bv = self.buckets[w][start]
                if bt <= t:
                    if best is None or bt > best[0]:
                        best = (bt, bv)
                    break
        return best

    def earliest(self) -> Optional[Tuple[float, Any]]:
        """Oldest anchor by TIMESTAMP across the raw ring and rollup
        tiers. The raw ring's head must win while it still holds the
        series' true start: a bucket stores its LAST cum value, so
        anchoring a window on it would zero out everything the bucket
        saw — a series younger than the window would never show a
        rate."""
        best: Optional[Tuple[float, Any]] = None
        for w in reversed(ROLLUP_WINDOWS_S):
            bk = self.buckets[w]
            if bk:
                cand = bk[next(iter(bk))]
                if best is None or cand[0] < best[0]:
                    best = cand
        if self.raw:
            cand = self.raw[0]
            if best is None or cand[0] < best[0]:
                best = cand
        return best


class MetricsStore:
    def __init__(self, max_series: Optional[int] = None,
                 raw_points: Optional[int] = None,
                 rollup_buckets: Optional[int] = None):
        self._max_series = max_series or CONFIG.health_store_max_series
        self._raw_points = raw_points or CONFIG.health_store_raw_points
        self._rollup_buckets = (rollup_buckets
                                or CONFIG.health_store_rollup_buckets)
        self._series: Dict[Tuple[str, Tuple], _Series] = {}
        self._lock = threading.RLock()
        self.series_dropped = 0      # new series refused past max_series
        self.points_ingested = 0
        self.snapshots_ingested = 0

    # -- ingest ---------------------------------------------------------------

    def _get_series(self, name: str, tags: Tuple, kind: str,
                    boundaries: Optional[List[float]] = None
                    ) -> Optional[_Series]:
        s = self._series.get((name, tags))
        if s is not None:
            # a kind collision (e.g. a gauge exposition mirror of a
            # series the GCS self-samples as a counter) must not corrupt
            # the established series — drop the mismatched ingest
            return s if s.kind == kind else None
        if len(self._series) >= self._max_series:
            self.series_dropped += 1
            return None
        s = _Series(name, tags, kind, self._raw_points, boundaries)
        self._series[(name, tags)] = s
        return s

    def ingest_snapshot(self, source: str, t: float,
                        snapshot: List[Dict]) -> None:
        """One process's cumulative ``snapshot_metrics`` payload."""
        with self._lock:
            self.snapshots_ingested += 1
            for entry in snapshot or []:
                name = entry.get("name")
                kind = entry.get("type")
                if not name or kind not in ("Counter", "Gauge", "Histogram"):
                    continue
                if kind == "Histogram":
                    for sample in entry.get("samples") or []:
                        tags_items, counts, total_sum, total = sample
                        self._ingest_hist(
                            source, t, name, _tags_key(dict(
                                (k, v) for k, v in tags_items)),
                            entry.get("boundaries") or [],
                            list(counts), float(total_sum), int(total))
                else:
                    for tags_items, value in entry.get("samples") or []:
                        tags = _tags_key(dict((k, v) for k, v in tags_items))
                        if kind == "Counter":
                            self._ingest_cum(source, t, name, tags,
                                             float(value))
                        else:
                            self._ingest_gauge(t, name, tags, float(value))

    def ingest_points(self, source: str, t: float,
                      points: List) -> None:
        """Gauge-style ad-hoc points: [[name, tags, value], ...] (the
        dashboard sampler's collected series)."""
        with self._lock:
            for name, tags, value in points or []:
                self._ingest_gauge(t, str(name), _tags_key(tags),
                                   float(value))

    def ingest_counter_absolute(self, source: str, t: float, name: str,
                                tags: Optional[Dict[str, str]],
                                value: float) -> None:
        """A counter fed from an ABSOLUTE cumulative total (e.g. the GCS
        event manager's per-type counts) rather than a registry
        snapshot."""
        with self._lock:
            self._ingest_cum(source, t, name, _tags_key(tags), float(value))

    def ingest_gauge(self, t: float, name: str,
                     tags: Optional[Dict[str, str]], value: float) -> None:
        with self._lock:
            self._ingest_gauge(t, name, _tags_key(tags), float(value))

    def _ingest_cum(self, source: str, t: float, name: str, tags: Tuple,
                    value: float) -> None:
        s = self._get_series(name, tags, "counter")
        if s is None:
            return
        prev = s.per_source.get(source)
        s.per_source[source] = value
        if prev is None:
            delta = 0.0       # baseline: pre-observation history is not a rate
        elif value >= prev:
            delta = value - prev
        else:
            delta = value     # source restarted: its counter began again at 0
        s.cum += delta
        s.add(t, s.cum, self._rollup_buckets)
        self.points_ingested += 1

    def _ingest_gauge(self, t: float, name: str, tags: Tuple,
                      value: float) -> None:
        s = self._get_series(name, tags, "gauge")
        if s is None:
            return
        s.cum = value
        s.add(t, value, self._rollup_buckets)
        self.points_ingested += 1

    def _ingest_hist(self, source: str, t: float, name: str, tags: Tuple,
                     boundaries: List[float], counts: List[int],
                     total_sum: float, total: int) -> None:
        s = self._get_series(name, tags, "histogram", boundaries)
        if s is None:
            return
        prev = s.per_source.get(source)
        s.per_source[source] = (counts, total_sum, total)
        if prev is None:
            d_counts, d_sum, d_n = [0] * len(counts), 0.0, 0  # baseline
        else:
            p_counts, p_sum, p_n = prev
            if total >= p_n and all(c >= p for c, p in zip(counts, p_counts)):
                d_counts = [c - p for c, p in zip(counts, p_counts)]
                d_sum, d_n = total_sum - p_sum, total - p_n
            else:             # source restarted
                d_counts, d_sum, d_n = list(counts), total_sum, total
        c_counts, c_sum, c_n = s.cum
        merged = [a + b for a, b in zip(c_counts, d_counts)]
        if len(d_counts) > len(merged):
            merged += d_counts[len(merged):]
        s.cum = (merged, c_sum + d_sum, c_n + d_n)
        s.add(t, (tuple(merged), s.cum[1], s.cum[2]), self._rollup_buckets)
        self.points_ingested += 1

    # -- matching -------------------------------------------------------------

    def _match(self, name: Optional[str],
               tags: Optional[Dict[str, str]]) -> List[_Series]:
        want = {str(k): str(v) for k, v in (tags or {}).items()}
        out = []
        for (sname, stags), s in self._series.items():
            if name is not None and sname != name \
                    and not fnmatchcase(sname, name):
                continue
            if want:
                d = dict(stags)
                if any(d.get(k) != v for k, v in want.items()):
                    continue
            out.append(s)
        return out

    # -- windowed reads (the SLO engine's primitives) -------------------------

    def window_delta(self, name: str, tags: Optional[Dict[str, str]],
                     since: float, now: Optional[float] = None
                     ) -> Optional[Tuple[float, float]]:
        """(delta, covered_s) summed across matching counter series over
        [since, now]; None when no matching series has any data."""
        now = now if now is not None else time.time()
        with self._lock:
            total = 0.0
            covered = 0.0
            seen = False
            for s in self._match(name, tags):
                if s.kind != "counter":
                    continue
                end = s.value_at(now)
                if end is None:
                    continue
                start = s.value_at(since)
                if start is None:
                    start = s.earliest()
                if start is None:
                    continue
                seen = True
                total += max(0.0, end[1] - start[1])
                covered = max(covered, end[0] - start[0])
            return (total, covered) if seen else None

    def window_rate(self, name: str, tags: Optional[Dict[str, str]],
                    window_s: float, now: Optional[float] = None
                    ) -> Optional[float]:
        """Per-second rate over the trailing window (None = no data)."""
        now = now if now is not None else time.time()
        got = self.window_delta(name, tags, now - window_s, now)
        if got is None:
            return None
        delta, _covered = got
        return delta / max(window_s, 1e-9)

    def window_quantile(self, name: str, tags: Optional[Dict[str, str]],
                        window_s: float, q: float,
                        now: Optional[float] = None) -> Optional[float]:
        """Histogram quantile over the trailing window, bucket deltas
        merged across matching series (None = no observations in the
        window)."""
        now = now if now is not None else time.time()
        since = now - window_s
        with self._lock:
            merged: List[float] = []
            boundaries: List[float] = []
            total = 0
            for s in self._match(name, tags):
                if s.kind != "histogram":
                    continue
                end = s.value_at(now)
                if end is None:
                    continue
                start = s.value_at(since) or s.earliest()
                e_counts, _e_sum, e_n = end[1]
                if start is not None:
                    s_counts, _s_sum, s_n = start[1]
                else:
                    s_counts, s_n = [0] * len(e_counts), 0
                d = [max(0, a - (s_counts[i] if i < len(s_counts) else 0))
                     for i, a in enumerate(e_counts)]
                if len(d) > len(merged):
                    merged += [0] * (len(d) - len(merged))
                for i, c in enumerate(d):
                    merged[i] += c
                total += max(0, e_n - s_n)
                if len(s.boundaries) > len(boundaries):
                    boundaries = list(s.boundaries)
            if total <= 0 or not boundaries:
                return None
            return Histogram._bucket_quantile(boundaries, merged, total, q)

    def latest_gauge(self, name: str, tags: Optional[Dict[str, str]] = None,
                     max_age_s: Optional[float] = None,
                     now: Optional[float] = None) -> Optional[float]:
        """Sum of the freshest value of every matching gauge series,
        ignoring series staler than `max_age_s` (None = no fresh data —
        'dead', which callers must distinguish from 'flat')."""
        now = now if now is not None else time.time()
        with self._lock:
            total = 0.0
            seen = False
            for s in self._match(name, tags):
                if s.kind != "gauge" or not s.raw:
                    continue
                t, v = s.raw[-1]
                if max_age_s is not None and now - t > max_age_s:
                    continue
                seen = True
                total += v
            return total if seen else None

    # -- the query RPC --------------------------------------------------------

    def query(self, name: Optional[str] = None,
              tags: Optional[Dict[str, str]] = None,
              since: Optional[float] = None,
              until: Optional[float] = None,
              resolution: str = "raw",
              limit_series: int = 200) -> List[Dict[str, Any]]:
        """Series matching name-glob + tag subset, each with its points
        in [since, until]. resolution 'raw' returns the ring points
        ([t, value] — cumulative for counters); '10s'/'1m' return
        rollup rows ({t, rate} for counters, {t, last/min/max/avg} for
        gauges, {t, rate, p50, p99} for histograms)."""
        if resolution not in RESOLUTIONS:
            raise ValueError(f"unknown resolution {resolution!r}")
        until = until if until is not None else time.time()
        since = since if since is not None else 0.0
        out: List[Dict[str, Any]] = []
        with self._lock:
            for s in self._match(name, tags):
                if len(out) >= max(1, limit_series):
                    break
                if resolution == "raw":
                    pts: List = []
                    for t, v in s.raw:
                        if t < since or t > until:
                            continue
                        if s.kind == "histogram":
                            pts.append([round(t, 3), v[2]])
                        else:
                            pts.append([round(t, 3), v])
                else:
                    pts = self._rollup_points(
                        s, RESOLUTIONS[resolution], since, until)
                last_t = s.raw[-1][0] if s.raw else None
                out.append({"name": s.name, "tags": dict(s.tags),
                            "kind": s.kind, "points": pts,
                            "last_t": last_t})
        return out

    def _rollup_points(self, s: _Series, window_s: float,
                       since: float, until: float) -> List[Dict[str, Any]]:
        bk = s.buckets[window_s]
        rows: List[Dict[str, Any]] = []
        prev: Optional[Tuple[float, Any]] = None
        for start in bk:
            agg = bk[start]
            if start + window_s < since or start > until:
                if s.kind != "gauge":
                    prev = agg
                continue
            if s.kind == "gauge":
                last, mn, mx, sm, n = agg
                rows.append({"t": start, "last": last, "min": mn,
                             "max": mx, "avg": sm / max(n, 1)})
                continue
            t, cum = agg
            if prev is None:
                base_t, base = start, None
            else:
                base_t, base = prev
            if s.kind == "counter":
                delta = (cum - base) if base is not None else 0.0
                rows.append({"t": start,
                             "rate": max(0.0, delta) / window_s})
            else:  # histogram
                e_counts, e_sum, e_n = cum
                if base is not None:
                    b_counts, b_sum, b_n = base
                else:
                    b_counts, b_sum, b_n = [0] * len(e_counts), 0.0, 0
                d_counts = [max(0, a - (b_counts[i] if i < len(b_counts)
                                        else 0))
                            for i, a in enumerate(e_counts)]
                d_n = max(0, e_n - b_n)
                row = {"t": start, "rate": d_n / window_s}
                if d_n > 0 and s.boundaries:
                    for q, label in ((0.5, "p50"), (0.99, "p99")):
                        row[label] = Histogram._bucket_quantile(
                            s.boundaries, d_counts, d_n, q)
                rows.append(row)
            prev = agg
        return rows

    def series_names(self) -> List[str]:
        with self._lock:
            return sorted({name for name, _tags in self._series})

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "series": len(self._series),
                "series_dropped": self.series_dropped,
                "points_ingested": self.points_ingested,
                "snapshots_ingested": self.snapshots_ingested,
                "max_series": self._max_series,
                "raw_points_per_series": self._raw_points,
            }
