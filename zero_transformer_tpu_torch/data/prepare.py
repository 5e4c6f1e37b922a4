"""Tokenize raw text into training shards.

Counterpart of ``zero_transformer_tpu/data/prepare.py`` (numpy and the
standard library, copied), in either format the port's loaders read:

- ``memmap``: one flat binary token stream (``uint16``/``uint32``), read by
  ``sources.MemmapSource`` as ``[n_rows, max_context]``;
- ``tar``: ``.tar.gz`` shards of ``.npy`` int32 rows plus an ``.index`` file
  listing them, read by ``tarshards.TarShardSource``.

Documents are concatenated with a separator token between them and chunked
into fixed ``max_context`` rows, the layout the packed-document models
expect (``ModelConfig.doc_sep_token`` derives the attention mask and the
loss boundaries from that separator). The trailing partial row is dropped.

Usage::

  python -m zero_transformer_tpu_torch.data.prepare \\
      --input corpus/*.txt --max-context 512 --format tar \\
      --rows-per-shard 1024 --doc-sep 0 --out data/corpus

``--tokenizer`` is ``bytes``, the byte-level tokenizer of the port's serve
CLI (vocab 256, no download), or a local directory holding a HuggingFace
tokenizer (``serve.load_tokenizer``: needs the ``transformers`` package; a
hub name raises). Documents are encoded without special tokens (JAX
``_encode``).
``--input`` takes ``.txt`` (one document per file) and ``.jsonl`` (one
document per line under a ``"text"`` key).
"""
from __future__ import annotations

import argparse
import glob
import io
import json
import sys
import tarfile
from pathlib import Path
from typing import Iterable, Iterator, List, Optional

import numpy as np


def iter_documents(inputs: List[str]) -> Iterator[str]:
    """Yield documents from .txt (whole file) / .jsonl ("text" per line)."""
    paths: List[str] = []
    for pattern in inputs:
        hits = sorted(glob.glob(pattern))
        if not hits:
            raise FileNotFoundError(f"no input matches {pattern!r}")
        paths.extend(hits)
    for p in paths:
        if p.endswith(".jsonl"):
            with open(p, encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    doc = json.loads(line)
                    text = doc["text"] if isinstance(doc, dict) else str(doc)
                    if text:
                        yield text
        else:
            text = Path(p).read_text(encoding="utf-8")
            if text:
                yield text


def load_tokenizer(name: str):
    """The serve CLI's dispatch: ``bytes``, or a local HuggingFace
    tokenizer directory."""
    from zero_transformer_tpu_torch.serve import load_tokenizer as load

    return load(name)


def _encode(tokenizer, doc: str) -> List[int]:
    """Tokenize WITHOUT special tokens: a tokenizer that prepends BOS or
    appends EOS would put stray tokens before every document."""
    try:
        return tokenizer.encode(doc, add_special_tokens=False)
    except TypeError:  # the byte tokenizer takes no such keyword
        return tokenizer.encode(doc)


def pack_rows(
    docs: Iterable[str], tokenizer, max_context: int, doc_sep_token: Optional[int],
) -> Iterator[np.ndarray]:
    """Concatenate tokenized docs (separator between them) into fixed rows.
    Streaming: holds at most one row plus one document of tokens. The final
    partial row is dropped."""
    buf: List[int] = []
    first = True
    for doc in docs:
        ids = _encode(tokenizer, doc)
        # keyed on "not the first document", not on a non-empty buffer: a
        # document that fills rows exactly leaves the buffer empty and must
        # still be separated from the next one
        if doc_sep_token is not None and not first:
            buf.append(doc_sep_token)
        first = False
        buf.extend(ids)
        # emit full rows by index, then truncate once (re-slicing per row
        # would be quadratic in a document's size)
        n_full = len(buf) // max_context
        for r in range(n_full):
            yield np.asarray(buf[r * max_context:(r + 1) * max_context], np.int32)
        if n_full:
            del buf[: n_full * max_context]


def write_memmap(rows: Iterator[np.ndarray], out: Path, dtype: str) -> int:
    """Append rows to one flat binary stream; returns rows written."""
    np_dtype = np.dtype(dtype)
    info = np.iinfo(np_dtype)
    n = 0
    with open(out, "wb") as f:
        for row in rows:
            # two-sided: a negative id would silently wrap under astype
            if row.min(initial=0) < info.min or row.max(initial=0) > info.max:
                raise ValueError(
                    f"token ids [{int(row.min())}, {int(row.max())}] out of range for {dtype}; "
                    "use --dtype uint32 or fix --doc-sep"
                )
            f.write(row.astype(np_dtype).tobytes())
            n += 1
    return n


def write_tar_shards(rows: Iterator[np.ndarray], out_prefix: Path, rows_per_shard: int) -> List[Path]:
    """Write .tar.gz shards of .npy rows plus an .index file."""
    shards: List[Path] = []
    tar: Optional[tarfile.TarFile] = None
    in_shard = 0
    try:
        for i, row in enumerate(rows):
            if tar is None:
                shard_path = Path(f"{out_prefix}-{len(shards):05d}.tar.gz")
                tar = tarfile.open(shard_path, "w:gz")
                shards.append(shard_path)
                in_shard = 0
            payload = io.BytesIO()
            np.save(payload, row)
            data = payload.getvalue()
            info = tarfile.TarInfo(name=f"{i:09d}.input_id.npy")
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
            in_shard += 1
            if in_shard >= rows_per_shard:
                tar.close()
                tar = None
    finally:
        if tar is not None:
            tar.close()
    index = Path(f"{out_prefix}.index")
    # entries are shard file names: read_index resolves them against the
    # index's own directory, so the dataset directory can move
    index.write_text("".join(f"{s.name}\n" for s in shards))
    return shards


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="zero_transformer_tpu_torch.data.prepare", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--input", nargs="+", required=True, help=".txt / .jsonl files or globs")
    p.add_argument("--tokenizer", default="bytes",
                   help='"bytes", or a local directory holding a HuggingFace tokenizer (needs transformers)')
    p.add_argument("--max-context", type=int, default=2048, help="row length")
    p.add_argument("--format", choices=("memmap", "tar"), default="memmap")
    p.add_argument("--out", required=True, help="output file (memmap) or shard prefix (tar)")
    p.add_argument("--dtype", default="uint16", help="memmap storage dtype")
    p.add_argument("--rows-per-shard", type=int, default=1024)
    p.add_argument("--doc-sep", type=int, default=None,
                   help="separator token id between documents (match model.doc_sep_token); "
                        "default: the tokenizer's EOS if it has one, else none")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    tokenizer = load_tokenizer(args.tokenizer)
    sep = args.doc_sep if args.doc_sep is not None else getattr(tokenizer, "eos_token_id", None)
    # validated once, for both formats: the tar path stores int32 and would
    # bake a negative separator into every document boundary
    if sep is not None and sep < 0:
        raise ValueError(f"--doc-sep must be a valid token id, got {sep}")
    rows = pack_rows(iter_documents(args.input), tokenizer, args.max_context, sep)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    if args.format == "memmap":
        n = write_memmap(rows, out, args.dtype)
        print(f"wrote {n} rows x {args.max_context} tokens ({args.dtype}) -> {out}")
    else:
        n = 0

        def counted():
            nonlocal n
            for r in rows:
                n += 1
                yield r

        shards = write_tar_shards(counted(), out, args.rows_per_shard)
        print(f"wrote {n} rows x {args.max_context} tokens over {len(shards)} shards "
              f"-> {out}-*.tar.gz (+ {out}.index)")
    if n == 0:
        print("warning: 0 full rows (inputs shorter than --max-context); nothing to train on",
              file=sys.stderr)


if __name__ == "__main__":
    main()
