"""The comparison that decides `correct`: a job's output files against
the plain reference (`reference.py`), each number beside its limit.

Numbers, each the worse of its readings on two jobs: the window's first
job, and one job run after the window on a dataset drawn from the run's
seed (all of the window's jobs ran the configuration's fixed reads):
- failed_jobs: jobs that exited non-zero or raised (answers that never came);
- jobs_unlike_first: jobs whose output files differ from the first's
  by a byte (the outputs are exact and the same reads go in);
- frq_rows_off: rows of PREFIX_<k>merFrq.tsv that differ from the exact
  occurrence distribution of the reads' canonical k-mers;
- unread_kmers: k-mers of the contig file's records that no read holds
  (every record is a walk of the reads' k-mers);
- header_off: records whose name is not the next seqN / junctionN, or
  whose len, read and maxK fields differ from the sequence's length, the
  reads' mean length and the schedule's last k;
- mismatch_per_10kbp: bases that differ from the genome where each
  record is best placed on it (a record placed nowhere counts whole), per
  10,000 record bases;
- size_gap_pct: the records' total length against the genome's, as a
  share of the genome;
- cov_gap_pct: the widest gap, as a share of the reference's, between
  the cov a header states and the record's read coverage as the reads'
  k-mers give it (`reference.record_coverage`), over the records of at
  least COV_MIN_BP bases (over all records where none is that long);
- upstream_set_off: where the configuration records the C++ Platanus_B
  v1.3.2's output for the mix's dataset (`upstream`), 1 if the sorted set
  of the records' canonical sequences differs from it (sha256), else 0;
- repeat_kmers_absent_pct: where the configuration plants repeat
  families (`repeats`), the share of the distinct canonical k-mers of the
  planted copies, as they lie in the genome, that no record holds: the
  repeats that the records' total length cannot see, since a port that
  drops them all moves size_gap_pct by their share of the genome alone.
All but mismatch_per_10kbp, size_gap_pct, cov_gap_pct and
repeat_kmers_absent_pct are exact (limit 0); those four are limited by
the configuration (`limits`), from sound runs and the controls (PERF.md).
"""

from __future__ import annotations

import hashlib
import re

from . import gen
from . import reference as ref

EXACT = ("failed_jobs", "jobs_unlike_first", "frq_rows_off", "unread_kmers",
         "header_off", "upstream_set_off")
JUDGED = ("frq_rows_off", "unread_kmers", "header_off", "mismatch_per_10kbp",
          "size_gap_pct", "cov_gap_pct")
REPEAT = "repeat_kmers_absent_pct"
COV_MIN_BP = 1000
HEADER = re.compile(rb"^(seq|junction)(\d+)_len(\d+)_cov(\d+)_read([0-9.]+)"
                    rb"_maxK(\d+)$")


def read_fasta(path: str) -> list[tuple[bytes, bytes]]:
    recs: list[list] = []
    with open(path, "rb") as f:
        for line in f:
            line = line.rstrip(b"\n")
            if line.startswith(b">"):
                recs.append([line[1:], []])
            elif recs:
                recs[-1][1].append(line)
    return [(name, b"".join(parts)) for name, parts in recs]


def read_tsv(path: str) -> dict[int, int]:
    rows = {}
    with open(path) as f:
        for line in f:
            occ, num = line.split("\t")
            rows[int(occ)] = int(num)
    return rows


def header_off(recs, read_len: float, max_k: int) -> int:
    off = 0
    nxt = {b"seq": 1, b"junction": 1}
    for name, seq in recs:
        m = HEADER.match(name)
        if m is None:
            off += 1
            continue
        kind, idx, ln, _cov, rl, mk = m.groups()
        ok = (int(idx) == nxt.get(kind) and int(ln) == len(seq)
              and float(rl) == read_len and int(mk) == max_k)
        nxt[kind] = int(idx) + 1
        off += not ok
    return off


def cov_gap_pct(recs, ref_cov) -> float | None:
    """The widest gap (%) between a header's cov and the reference's
    coverage of that record, over the records of at least COV_MIN_BP
    bases, or over all records where none is that long; None where no
    record can be compared (no header, or no k-window)."""
    gaps, lens = [], []
    for (name, seq), want in zip(recs, ref_cov):
        m = HEADER.match(name)
        if m is None or not want > 0:
            continue
        gaps.append(float(100.0 * abs(int(m.group(4)) - want) / want))
        lens.append(len(seq))
    long = [g for g, n in zip(gaps, lens) if n >= COV_MIN_BP]
    return max(long or gaps) if gaps else None


def sorted_set_sha256(seqs: list[bytes]) -> str:
    """sha256 of the records' canonical sequences (the smaller of each and
    its reverse complement), sorted, one a line: the parity records' rule."""
    canon = sorted(min(s, ref.revcomp(s)) for s in seqs)
    return hashlib.sha256(b"\n".join(canon)).hexdigest()


def judged_names(inputs) -> tuple:
    """The numbers `judge` reads from one job's outputs on `inputs`."""
    return JUDGED + ((REPEAT,) if inputs.plan.copies else ())


def judge(files: dict, inputs, k: int, device,
          upstream: str | None = None) -> tuple[dict, dict]:
    """(numbers, what the reference found) of one job's outputs: `files`
    maps each output suffix of the mix to its path; `inputs` holds the
    genome and the reads; `upstream` the C++ program's contig set hash."""
    dist, keys, counts = ref.kmer_table(inputs.reads, k, device)
    rows = read_tsv(files[f"_{k}merFrq.tsv"])
    top = max([o for o in range(len(dist)) if dist[o]] + list(rows) + [0])
    frq_off = sum(rows.get(o, 0) != int(dist[o]) for o in range(1, top + 1))
    read_len = float(inputs.reads.shape[1])
    ks = ref.k_schedule(dist, read_len, k)
    max_k = ks[-1]
    recs = read_fasta(files["_contig.fa"])
    seqs = [s for _n, s in recs]
    genome = inputs.genome_text
    mism = sum(len(s) if m is None else m for s, m in
               zip(seqs, ref.GenomeIndex(genome).mismatches(seqs)))
    total = sum(len(s) for s in seqs)
    numbers = {"frq_rows_off": frq_off,
               "unread_kmers": ref.absent_kmers(seqs, keys, counts, k),
               "header_off": header_off(recs, read_len, max_k),
               "mismatch_per_10kbp": 1e4 * mism / max(total, 1),
               "size_gap_pct": 100.0 * abs(total - len(genome)) / len(genome),
               "cov_gap_pct": cov_gap_pct(recs, ref.record_coverage(
                   seqs, keys, counts, k, read_len))}
    if inputs.plan.copies:
        copies = [gen.BASES[c].tobytes()
                  for c in inputs.plan.sequences(inputs.genome)]
        numbers[REPEAT] = ref.absent_share(
            ref.distinct_kmers(copies, k, device),
            ref.distinct_kmers(seqs, k, device))
    if upstream is not None:
        numbers["upstream_set_off"] = int(sorted_set_sha256(seqs) != upstream)
    info = {"ks": ks, "cutoff": max(ref.left_local_minimum(dist) // 2, 2),
            "records": len(recs), "junctions": sum(
                n.startswith(b"junction") for n, _s in recs),
            "record_bp": total, "mismatches": mism}
    return numbers, info


def worst(a: dict, b: dict) -> dict:
    """Each number of `a` and `b` at the worse of its two readings; one
    that either could not read (None) stays None."""
    out = dict(a)
    for name, value in b.items():
        if name not in out:
            out[name] = value
        elif out[name] is None or value is None:
            out[name] = None
        else:
            out[name] = max(out[name], value)
    return out


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}); a number that could not be
    read (None) fails."""
    out, ok = {}, True
    for name, value in numbers.items():
        limit = 0 if name in EXACT else limits[name]
        out[name] = {"value": value, "limit": limit}
        ok &= value is not None and value <= limit
    return ok, out
