"""Voice packaging — the make_htsvoice equivalent (Training.pl:2303-2609,
SURVEY.md T6): one `.htsvoice` file with [GLOBAL]/[STREAM]/[POSITION]
sections and concatenated binary payloads (duration pdf/tree, per-stream
pdfs/trees, delta windows, optional GV pdfs).

The container layout (section headers, POSITION byte ranges, VOCODER:WORLD
tag) follows the reference exactly; payloads use the hts_engine
conventions: trees in HHEd text form, pdfs as little-endian float32 blocks
of [mean | variance (| msd-weight)] per leaf per state, preceded by an
int32 leaf count per state.

The port's own copy of `hts_train_world_tpu/models/voice.py` (host code):
the same model gives the same bytes.
"""
from __future__ import annotations

import dataclasses
import io
import struct
from typing import Dict, List, Optional, Sequence

import numpy as np

from hts_train_world_tpu_torch.models.clustering import Tree, tree_to_hts_text

STREAM_NAMES = {"mgc": "MGC", "lf0": "LF0", "bap": "BAP", "vib": "VIB",
                "dur": "DUR"}


@dataclasses.dataclass
class StreamPack:
    name: str                     # mgc | lf0 | bap | vib
    vector_length: int            # static order (e.g. 50 for mgc)
    is_msd: bool
    n_windows: int
    trees: List[Tree]             # one per state
    msd_weights: Optional[List[np.ndarray]] = None  # per state, per leaf
    use_gv: bool = False
    option: str = ""
    gv_tree: Optional[Tree] = None   # single-state GV pdf tree (MCDGV)


def _pdf_payload(trees: Sequence[Tree], msd_weights=None) -> bytes:
    buf = io.BytesIO()
    for tree in trees:
        buf.write(struct.pack("<i", tree.n_leaves))
    for s, tree in enumerate(trees):
        for li, (mean, var) in enumerate(tree.leaf_params):
            buf.write(np.asarray(mean, "<f4").tobytes())
            buf.write(np.asarray(var, "<f4").tobytes())
            if msd_weights is not None:
                w = float(msd_weights[s][li])
                buf.write(struct.pack("<ff", w, 1.0 - w))
    return buf.getvalue()


def _collect_questions(trees: Sequence[Tree]):
    seen = {}
    for t in trees:
        def walk(n):
            if n.question is not None:
                seen[n.question.name] = n.question
                walk(n.yes)
                walk(n.no)
        walk(t.root)
    return seen


def _tree_payload(trees: Sequence[Tree], name: str) -> bytes:
    qs = _collect_questions(trees)
    head = "".join(f'QS "{q.name}" {{{",".join(q.patterns)}}}\n'
                   for q in qs.values())
    return (head + "".join(tree_to_hts_text(t, name, s)
                           for s, t in enumerate(trees))).encode()


def _window_file(w) -> bytes:
    """One data/win/*.win file: 'N v1 .. vN\\n' with python float repr
    (matches the shipped files byte-for-byte: '1 1.0', '3 -0.5 0.0 0.5')."""
    return (f"{len(w)} " + " ".join(str(float(v)) for v in w) + "\n").encode()


def export_htsvoice(path: str, fs: int, frame_shift: int, n_states: int,
                    streams: Sequence[StreamPack], dur: StreamPack,
                    windows=((1.0,), (-0.5, 0.0, 0.5), (1.0, -2.0, 1.0)),
                    fullcontext_format: str = "HTS_TTS_JPN",
                    fullcontext_version: str = "1.0",
                    gv_off_context: Sequence[str] = ()) -> None:
    """Write the voice with the reference's literal section/POSITION
    layout (make_htsvoice, Training.pl:2303-2609): [GLOBAL] line order
    including the GV_OFF_CONTEXT line (blank when $nosilgv is off) and
    the empty COMMENT; [POSITION] order DURATION_PDF, DURATION_TREE,
    per-stream STREAM_WIN (comma-separated per-window byte ranges — one
    range per win file), then ALL STREAM_PDF, then ALL STREAM_TREE, then
    GV_PDF for use_gv streams, then GV_TREE for context-dependent GV."""
    payloads: List[bytes] = []
    positions: List[str] = []
    offset = [0]

    def add_payload(data: bytes) -> str:
        s = offset[0]
        payloads.append(data)
        offset[0] += len(data)
        return f"{s}-{s + len(data) - 1}"

    def add(tag: str, data: bytes):
        positions.append(f"{tag}:{add_payload(data)}")

    add("DURATION_PDF", _pdf_payload(dur.trees))
    add("DURATION_TREE", _tree_payload(dur.trees, "dur"))
    for st in streams:
        tag = STREAM_NAMES.get(st.name, st.name.upper())
        ranges = ",".join(add_payload(_window_file(w))
                          for w in windows[:st.n_windows])
        positions.append(f"STREAM_WIN[{tag}]:{ranges}")
    for st in streams:
        tag = STREAM_NAMES.get(st.name, st.name.upper())
        add(f"STREAM_PDF[{tag}]",
            _pdf_payload(st.trees,
                         st.msd_weights if st.is_msd else None))
    for st in streams:
        tag = STREAM_NAMES.get(st.name, st.name.upper())
        add(f"STREAM_TREE[{tag}]", _tree_payload(st.trees, st.name))
    for st in streams:
        if st.use_gv and st.gv_tree is not None:
            tag = STREAM_NAMES.get(st.name, st.name.upper())
            add(f"GV_PDF[{tag}]", _pdf_payload([st.gv_tree]))
    for st in streams:
        if st.use_gv and st.gv_tree is not None:
            tag = STREAM_NAMES.get(st.name, st.name.upper())
            add(f"GV_TREE[{tag}]", _tree_payload([st.gv_tree],
                                                 f"gv-{st.name}"))

    header = io.StringIO()
    header.write("[GLOBAL]\n")
    header.write("HTS_VOICE_VERSION:1.0\n")
    header.write(f"SAMPLING_FREQUENCY:{fs}\n")
    header.write(f"FRAME_PERIOD:{frame_shift}\n")
    header.write(f"NUM_STATES:{n_states}\n")
    header.write(f"NUM_STREAMS:{len(streams)}\n")
    header.write("STREAM_TYPE:" + ",".join(
        STREAM_NAMES.get(s.name, s.name.upper()) for s in streams) + "\n")
    header.write(f"FULLCONTEXT_FORMAT:{fullcontext_format}\n")
    header.write(f"FULLCONTEXT_VERSION:{fullcontext_version}\n")
    header.write("VOCODER:WORLD\n")
    # the reference prints the GV_OFF_CONTEXT values under $nosilgv and
    # then an unconditional newline (Training.pl:2342-2351) — a voice
    # without silence-GV exclusion carries a blank line here
    if gv_off_context:
        header.write("GV_OFF_CONTEXT:" + ",".join(
            f'"*-{s}+*"' for s in gv_off_context))
    header.write("\n")
    header.write("COMMENT:\n")
    header.write("[STREAM]\n")
    for st in streams:
        tag = STREAM_NAMES.get(st.name, st.name.upper())
        header.write(f"VECTOR_LENGTH[{tag}]:{st.vector_length}\n")
    for st in streams:
        tag = STREAM_NAMES.get(st.name, st.name.upper())
        header.write(f"IS_MSD[{tag}]:{int(st.is_msd)}\n")
    for st in streams:
        tag = STREAM_NAMES.get(st.name, st.name.upper())
        header.write(f"NUM_WINDOWS[{tag}]:{st.n_windows}\n")
    for st in streams:
        tag = STREAM_NAMES.get(st.name, st.name.upper())
        header.write(f"USE_GV[{tag}]:{int(st.use_gv)}\n")
    for st in streams:
        tag = STREAM_NAMES.get(st.name, st.name.upper())
        header.write(f"OPTION[{tag}]:{st.option}\n")
    header.write("[POSITION]\n")
    for p in positions:
        header.write(p + "\n")
    header.write("[DATA]\n")

    with open(path, "wb") as f:
        f.write(header.getvalue().encode())
        for p in payloads:
            f.write(p)


def read_htsvoice_header(path: str) -> Dict[str, str]:
    """Parse the text header back (sanity / tests)."""
    out = {}
    with open(path, "rb") as f:
        data = f.read()
    text = data[:data.index(b"[DATA]\n") + 7].decode()
    for line in text.splitlines():
        if ":" in line and not line.startswith("["):
            k, v = line.split(":", 1)
            out[k] = v
    return out


# ---------------------------------------------------------------------------
# loader (the hts_engine-side of the contract)
# ---------------------------------------------------------------------------


def _parse_trees(text: str, dim: int, payload: bytes, msd: bool):
    """Rebuild Tree objects from a tree payload + its pdf payload."""
    from hts_train_world_tpu_torch.models.clustering import Node, Question, Tree
    questions = {}
    tree_blocks: List[List[str]] = []
    cur: Optional[List[str]] = None
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("QS "):
            name = line.split('"')[1]
            patts = line[line.index("{") + 1:line.rindex("}")].split(",")
            questions[name] = Question(name, patts)
        elif line.startswith("{*}"):
            cur = []
            tree_blocks.append(cur)
        elif cur is not None and line.startswith('"'):
            cur.append("LEAF")  # single-leaf tree body
        elif cur is not None and line and line != "}":
            cur.append(line)

    n_states = len(tree_blocks)
    counts = struct.unpack(f"<{n_states}i", payload[:4 * n_states])
    off = 4 * n_states
    per_leaf = dim * 2 + (2 if msd else 0)
    trees = []
    msd_w = []
    for s, block in enumerate(tree_blocks):
        leaves = []
        weights = []
        for _ in range(counts[s]):
            vals = np.frombuffer(payload, "<f4", per_leaf, off)
            off += per_leaf * 4
            leaves.append((vals[:dim].astype(float),
                           vals[dim:2 * dim].astype(float)))
            if msd:
                weights.append(float(vals[2 * dim]))
        if block and block[0] == "LEAF":
            root = Node(leaf_id=0)
        else:
            import re as _re
            nodes = {}
            for line in block:
                # ' -id "QName" <noRef> <yesRef>' (refs may be quoted leaves)
                toks = _re.findall(r'"[^"]*"|\S+', line)
                nid = int(toks[0])
                nodes[nid] = (toks[1].strip('"'), toks[2], toks[3])

            def build(ref: str) -> Node:
                if ref.startswith('"'):
                    leaf_id = int(ref.strip('"').rsplit("_", 1)[1]) - 1
                    return Node(leaf_id=leaf_id)
                qname, no_ref, yes_ref = nodes[int(ref)]
                return Node(questions[qname], build(yes_ref), build(no_ref))

            # HHEd numbering: root is node 0, deeper nodes are -1, -2, ...
            root = build(str(max(nodes)))
        trees.append(Tree(root, leaves))
        msd_w.append(np.asarray(weights) if msd else None)
    return trees, msd_w


def load_htsvoice(path: str):
    """Load an exported voice back into per-stream trees + params:
    {stream: {"trees": [Tree], "msd_weights": [...], "windows": [...],
    "gv_tree": Tree|None}} plus globals."""
    hdr = read_htsvoice_header(path)
    data = open(path, "rb").read()
    body = data[data.index(b"[DATA]\n") + 7:]

    def one_range(r):
        s, e = (int(v) for v in r.split("-"))
        if s < 0 or e < s or e >= len(body):
            raise ValueError(
                f"htsvoice range {r} outside DATA section "
                f"({len(body)} bytes) — truncated or corrupt file")
        return body[s:e + 1]

    def payload(tag):
        return one_range(hdr[tag])

    stream_names = hdr["STREAM_TYPE"].split(",")
    inv = {v: k for k, v in STREAM_NAMES.items()}
    out = {"global": hdr, "streams": {}}
    n_states = int(hdr["NUM_STATES"])
    dur_trees, _ = _parse_trees(payload("DURATION_TREE").decode(),
                                n_states, payload("DURATION_PDF"), False)
    out["duration"] = dur_trees
    for tag in stream_names:
        name = inv.get(tag, tag.lower())
        dim_static = int(hdr[f"VECTOR_LENGTH[{tag}]"])
        msd = hdr[f"IS_MSD[{tag}]"] == "1"
        # pdf dim = leaf mean length; infer from payload via counts
        ttext = payload(f"STREAM_TREE[{tag}]").decode()
        pdf = payload(f"STREAM_PDF[{tag}]")
        # infer dim: total bytes = 4*S + sum(counts)*(2*dim(+2))*4
        # (counts are the first S int32s)
        counts = struct.unpack(f"<{n_states}i", pdf[:4 * n_states])
        total = len(pdf) - 4 * n_states
        per_leaf_f = total // (4 * sum(counts))
        dim = (per_leaf_f - (2 if msd else 0)) // 2
        trees, msd_w = _parse_trees(ttext, dim, pdf, msd)
        # delta windows: one byte range per window file
        windows = []
        for r in hdr[f"STREAM_WIN[{tag}]"].split(","):
            toks = one_range(r).decode().split()
            windows.append(tuple(float(v) for v in toks[1:]))
        gv_tree = None
        if hdr.get(f"GV_PDF[{tag}]"):
            gpdf = payload(f"GV_PDF[{tag}]")
            (gcount,) = struct.unpack("<i", gpdf[:4])
            gdim = (len(gpdf) - 4) // (8 * gcount)
            if f"GV_TREE[{tag}]" in hdr:
                gtrees, _ = _parse_trees(
                    payload(f"GV_TREE[{tag}]").decode(), gdim, gpdf, False)
                gv_tree = gtrees[0]
            else:
                vals = np.frombuffer(gpdf, "<f4", 2 * gdim, 4)
                from hts_train_world_tpu_torch.models.clustering import Node, Tree
                gv_tree = Tree(Node(leaf_id=0),
                               [(vals[:gdim].astype(float),
                                 vals[gdim:].astype(float))])
        out["streams"][name] = {"trees": trees, "msd_weights": msd_w,
                                "static_dim": dim_static, "is_msd": msd,
                                "windows": windows, "gv_tree": gv_tree}
    return out
