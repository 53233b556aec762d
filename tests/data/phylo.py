"""Phylogeny-driven test-data simulation: the Python equivalent of the
reference's R generators (test/clusters-tb.R:19-52, test/clusters-covid.R:27-37),
which simulate genomes down a Newick tree with phangorn::simSeq and then
Illumina reads with ART.

Pieces:
- a minimal Newick parser/writer (branch lengths, nested clades),
- a seeded random clade-tree generator producing the covid-like shape
  (many sibling classes, tips labelled ``<id>-<class>`` like the
  reference's trees),
- JC69 sequence evolution down the tree (simSeq's default model),
- a paired-end read simulator in the shape of the reference's
  ``art_illumina -p -l 150 -f 20 -m 200 -s 10`` invocation.

Everything is deterministic given the RNG seed.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

BASES = np.array(list("ACGT"))


# ---------------- tree ----------------


@dataclass
class Node:
    name: str = ""
    length: float = 0.0
    children: List["Node"] = field(default_factory=list)

    @property
    def is_tip(self) -> bool:
        return not self.children

    def tips(self) -> List["Node"]:
        if self.is_tip:
            return [self]
        out: List[Node] = []
        stack = [self]
        while stack:
            n = stack.pop()
            if n.is_tip:
                out.append(n)
            else:
                stack.extend(reversed(n.children))
        return out


def parse_newick(s: str) -> Node:
    """Parse a Newick string (names + branch lengths; no comments)."""
    s = s.strip()
    if s.endswith(";"):
        s = s[:-1]
    pos = 0

    def parse_node() -> Node:
        nonlocal pos
        node = Node()
        if s[pos] == "(":
            pos += 1
            while True:
                node.children.append(parse_node())
                if s[pos] == ",":
                    pos += 1
                    continue
                if s[pos] == ")":
                    pos += 1
                    break
        # name
        start = pos
        while pos < len(s) and s[pos] not in ",():;":
            pos += 1
        node.name = s[start:pos]
        if pos < len(s) and s[pos] == ":":
            pos += 1
            start = pos
            while pos < len(s) and s[pos] not in ",()":
                pos += 1
            node.length = float(s[start:pos])
        return node

    root = parse_node()
    if pos != len(s):
        raise ValueError(f"trailing newick input at {pos}: {s[pos:pos+20]!r}")
    return root


def write_newick(node: Node) -> str:
    def fmt(n: Node) -> str:
        inner = (
            "(" + ",".join(fmt(c) for c in n.children) + ")"
            if n.children
            else ""
        )
        ln = (":%.10g" % n.length) if n.length else ""
        return inner + n.name + ln

    return fmt(node) + ";"


def random_clade_tree(
    rng: np.random.Generator,
    n_classes: int,
    tips_per_class: int,
    between: float = 1.0,
    within: float = 0.05,
) -> Node:
    """Covid-shaped tree: ``n_classes`` sibling clades hanging off the root,
    each a random binary subtree of ``tips_per_class`` tips with short
    internal branches (many similar classes).  Tips are ``<id>-<class>``
    (1-based class), matching the reference's tip-label convention."""
    tip_id = 0

    def random_subtree(tip_names: List[str]) -> Node:
        nodes = [
            Node(name=nm, length=float(rng.exponential(within)))
            for nm in tip_names
        ]
        while len(nodes) > 1:
            i, j = rng.choice(len(nodes), size=2, replace=False)
            i, j = (i, j) if i < j else (j, i)
            parent = Node(
                length=float(rng.exponential(within)),
                children=[nodes[i], nodes[j]],
            )
            nodes = [n for t, n in enumerate(nodes) if t not in (i, j)]
            nodes.append(parent)
        return nodes[0]

    clades = []
    for c in range(1, n_classes + 1):
        names = []
        for _ in range(tips_per_class):
            tip_id += 1
            names.append(f"{tip_id}-{c}")
        clade = random_subtree(names)
        clade.length = between * (0.5 + float(rng.random()))
        clades.append(clade)
    return Node(children=clades)


# ---------------- sequence evolution (JC69, simSeq default) ----------------


def sim_seq(
    rng: np.random.Generator,
    tree: Node,
    rootseq: np.ndarray,
    rate: float = 1.0,
) -> Dict[str, np.ndarray]:
    """Evolve ``rootseq`` (int codes 0..3) down the tree under JC69: along a
    branch of length t each site substitutes with probability
    ``3/4 * (1 - exp(-4/3 * rate * t))``, uniformly to one of the other
    bases — phangorn::simSeq's default model."""
    out: Dict[str, np.ndarray] = {}

    def walk(node: Node, seq: np.ndarray) -> None:
        if node.length > 0:
            p = 0.75 * (1.0 - np.exp(-4.0 / 3.0 * rate * node.length))
            hit = rng.random(len(seq)) < p
            n = int(hit.sum())
            if n:
                seq = seq.copy()
                seq[hit] = (seq[hit] + rng.integers(1, 4, size=n)) % 4
        if node.is_tip:
            out[node.name] = seq
        else:
            for c in node.children:
                walk(c, seq)

    walk(tree, np.asarray(rootseq))
    return out


def codes_to_str(codes: np.ndarray) -> str:
    return "".join(BASES[codes])


# ---------------- read simulation (the art_illumina stand-in) ----------------


def sim_paired_reads(
    rng: np.random.Generator,
    genome: np.ndarray,
    read_len: int = 150,
    coverage: float = 20.0,
    insert_mean: float = 200.0,
    insert_sd: float = 10.0,
    error_rate: float = 0.002,
) -> Tuple[List[str], List[str]]:
    """Paired-end reads in the shape of the reference's ART invocation
    (test/clusters-tb.R:42: ``-p -l 150 -f 20 -m 200 -s 10``): fragments of
    ~N(insert_mean, insert_sd), read 1 from the 5' end, read 2 the reverse
    complement of the 3' end, uniform substitution errors."""
    L = len(genome)
    n_pairs = max(1, int(L * coverage / (2 * read_len)))
    r1: List[str] = []
    r2: List[str] = []
    for _ in range(n_pairs):
        frag = max(read_len, int(rng.normal(insert_mean, insert_sd)))
        frag = min(frag, L)
        start = int(rng.integers(0, L - frag + 1))
        fwd = genome[start : start + read_len].copy()
        rev = genome[start + frag - read_len : start + frag][::-1].copy()
        rev = 3 - rev  # complement of reversed = revcomp
        for read in (fwd, rev):
            err = rng.random(read_len) < error_rate
            n = int(err.sum())
            if n:
                read[err] = (read[err] + rng.integers(1, 4, size=n)) % 4
        r1.append(codes_to_str(fwd))
        r2.append(codes_to_str(rev))
    return r1, r2


def write_fastq(path: str, reads: List[str], name_prefix: str = "r") -> None:
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write("@%s%d\n%s\n+\n%s\n" % (name_prefix, i, r, "I" * len(r)))


# ---------------- class corpus (a covid-shaped training table) ----------------


def class_corpus(
    rng: np.random.Generator,
    window_codes,
    n_classes: int,
    genome_len: int,
    tips_per_class: int = 4,
    between: float = 0.08,
    within: float = 0.15,
    rate: float = 0.01,
):
    """Sibling clades with within-class divergence comparable to
    between-class (the difficulty of the reference's SARS-CoV-2 lineage
    classifier).  The first half of each clade's tips (by tip id) are
    summed into that class's training spectrum; the rest are held out.

    ``window_codes(genome) -> k-mer codes`` counts one genome (e.g.
    ``KmerSpace.window_codes``).  Returns (vocab: sorted codes [V],
    table: [V, n_classes] int32 counts, held_out: [(class, genome int8)]).
    """
    tree = random_clade_tree(
        rng, n_classes, tips_per_class, between=between, within=within
    )
    root = rng.integers(0, 4, size=genome_len)
    by_class: Dict[int, list] = {}
    for name, codes in sim_seq(rng, tree, root, rate=rate).items():
        tip, cls = name.split("-")
        by_class.setdefault(int(cls) - 1, []).append((int(tip), codes))
    spectra = []
    held_out = []
    for c in range(n_classes):
        members = sorted(by_class[c], key=lambda t: t[0])
        half = len(members) // 2
        wc = np.concatenate([window_codes(g) for _, g in members[:half]])
        spectra.append(np.unique(wc, return_counts=True))
        held_out.extend((c, g.astype(np.int8)) for _, g in members[half:])
    vocab = np.unique(np.concatenate([u for u, _ in spectra]))
    table = np.zeros((len(vocab), n_classes), dtype=np.int32)
    for c, (u, n) in enumerate(spectra):
        table[np.searchsorted(vocab, u), c] = n
    return vocab, table, held_out
