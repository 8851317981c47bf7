"""GGUF tooling CLI (reference gguf/scripts/* + script 07).

  python -m qwen3_asr_gguf_tpu_torch.formats dump model.gguf [--tensors] [--kv]
  python -m qwen3_asr_gguf_tpu_torch.formats requant in.f16.gguf out.q4_k.gguf --quant q4_k
  python -m qwen3_asr_gguf_tpu_torch.formats hash model.gguf [--no-tensors]
  python -m qwen3_asr_gguf_tpu_torch.formats set-metadata model.gguf out.gguf --set k=v [...]
  python -m qwen3_asr_gguf_tpu_torch.formats new-metadata model.gguf out.gguf \
      [--set k=v] [--remove k] [--chat-template FILE]
  python -m qwen3_asr_gguf_tpu_torch.formats endian model.gguf [out.gguf --to big|little]
"""

from __future__ import annotations

import argparse
import hashlib
import sys

import numpy as np

from . import quants
from .gguf import GGUFReader, GGUFWriter


def cmd_dump(args) -> int:
    r = GGUFReader(args.path)
    if args.kv or not args.tensors:
        print("# metadata")
        for k, v in r.kv.items():
            if isinstance(v, (list, np.ndarray)) and len(v) > 8:
                print(f"  {k}: [{len(v)} items] {list(v[:4])}...")
            else:
                print(f"  {k}: {v}")
    if args.tensors or not args.kv:
        print(f"# tensors ({len(r.tensors)})")
        total = 0
        for name, ti in r.tensors.items():
            total += ti.nbytes
            print(f"  {name:40s} {str(ti.shape):>20s} {ti.type_name:>6s} {ti.nbytes/1e6:9.2f} MB")
        print(f"# total payload {total/1e9:.3f} GB")
    return 0


def _copy_kv(w: GGUFWriter, kv: dict, *, skip=(), override=None) -> None:
    """Replicate a reader's KV store into a writer (typed best-effort)."""
    override = dict(override or {})
    w._kv = []  # rebuild all KV from source
    for k, v in kv.items():
        if k == "general.alignment" or k in skip:
            continue
        if k in override:
            v = override.pop(k)
        _add_kv_typed(w, k, v)
    for k, v in override.items():
        _add_kv_typed(w, k, v)
    w.add_kv("general.alignment", 4, 32)


def _add_kv_typed(w: GGUFWriter, k: str, v) -> None:
    if isinstance(v, bool):
        w.add_bool(k, v)
    elif isinstance(v, int):
        w.add_u32(k, v) if 0 <= v < 2**32 else w.add_kv(k, 11, v)
    elif isinstance(v, float):
        w.add_f32(k, v)
    elif isinstance(v, str):
        w.add_string(k, v)
    elif isinstance(v, np.ndarray):
        w.add_i32_array(k, v.astype(np.int64).tolist())
    elif isinstance(v, list) and v and isinstance(v[0], str):
        w.add_str_array(k, v)
    elif isinstance(v, list) and v and isinstance(v[0], int):
        w.add_i32_array(k, v)


def _parse_value(s: str):
    """CLI value parsing: bool/int/float fall through to string."""
    if s.lower() in ("true", "false"):
        return s.lower() == "true"
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        pass
    return s


def cmd_requant(args) -> int:
    """f16/f32 GGUF -> block-quantized GGUF (reference 07-Quantize-*.py via
    llama-quantize). 2-D matmul weights get --quant; norms stay f32;
    token_embd/output get q6_k under q4_k (q4_k_m convention)."""
    r = GGUFReader(args.path)
    w = GGUFWriter(args.out, arch=r.kv.get("general.architecture", "qwen3vl"))
    _copy_kv(w, r.kv)

    mat_type = quants.NAME_TO_TYPE[args.quant]
    embd_type = quants.GGML_Q6_K if args.quant == "q4_k" else mat_type
    n_q = 0
    for name, ti in r.tensors.items():
        data = r.tensor(name, dtype=np.float32)
        if len(ti.shape) == 2 and ti.shape[-1] % quants.QUANT_SIZES[mat_type][0] == 0:
            t = embd_type if name in ("token_embd.weight", "output.weight") else mat_type
            n_q += 1
        else:
            t = quants.GGML_F32
        w.add_tensor(name, data, t)
    w.write()
    print(f"wrote {args.out}: {n_q} tensors quantized to {args.quant}")
    return 0


def cmd_hash(args) -> int:
    """Per-tensor + whole-model SHA-256 (reference gguf_hash.py)."""
    r = GGUFReader(args.path)
    overall = hashlib.sha256()
    for name, ti in sorted(r.tensors.items()):
        raw = r.tensor_bytes(name)
        overall.update(raw)
        if not args.no_tensors:
            print(f"sha256  {hashlib.sha256(raw).hexdigest()}  {args.path}:{name}")
    print(f"sha256  {overall.hexdigest()}  {args.path} (tensor payload)")
    return 0


def _rewrite_with_metadata(path: str, out: str, *, set_kv=None, remove=()) -> int:
    r = GGUFReader(path)
    w = GGUFWriter(out, arch=r.kv.get("general.architecture", "qwen3vl"))
    _copy_kv(w, r.kv, skip=tuple(remove), override=set_kv or {})
    for name, ti in r.tensors.items():
        # pass tensor payloads through untouched (no dequant/requant)
        w.add_raw_tensor(name, r.tensor_bytes(name), ti.shape, ti.ggml_type)
    w.write()
    n_set = len(set_kv or {})
    print(f"wrote {out}: {n_set} key(s) set, {len(tuple(remove))} removed")
    return 0


def cmd_set_metadata(args) -> int:
    """Change metadata values (reference gguf_set_metadata.py; rewrites the
    file instead of patching bytes in place)."""
    sets = dict(kv.split("=", 1) for kv in args.set)
    return _rewrite_with_metadata(
        args.path, args.out, set_kv={k: _parse_value(v) for k, v in sets.items()}
    )


def cmd_new_metadata(args) -> int:
    """Copy a GGUF with added/removed metadata (reference gguf_new_metadata.py)."""
    sets = {k: _parse_value(v) for k, v in (kv.split("=", 1) for kv in args.set or [])}
    if args.chat_template:
        with open(args.chat_template, encoding="utf-8") as f:
            sets["tokenizer.chat_template"] = f.read()
    return _rewrite_with_metadata(args.path, args.out, set_kv=sets,
                                  remove=args.remove or [])


def cmd_endian(args) -> int:
    """Report (and convert) file endianness (reference gguf_convert_endian.py).

    GGUF files this package writes are little-endian (magic 'GGUF' + LE
    version field). Conversion byte-swaps f32/f16/int tensor payloads; block-
    quantized tensors are refused (their packed sub-byte layout is
    endian-sensitive in ways a plain swap cannot fix)."""
    with open(args.path, "rb") as f:
        magic = f.read(4)
        ver = f.read(4)
    if magic != b"GGUF":
        print("not a GGUF file")
        return 1
    little = int.from_bytes(ver, "little") in (1, 2, 3)
    print(f"{args.path}: {'little' if little else 'big'}-endian "
          f"(version {int.from_bytes(ver, 'little' if little else 'big')})")
    if not args.out:
        return 0
    if (args.to == "little") == little:
        print("already requested endianness; nothing to do")
        return 0
    r = GGUFReader(args.path)
    swappable = {quants.GGML_F32, quants.GGML_F16}
    for name, ti in r.tensors.items():
        if ti.ggml_type not in swappable:
            print(f"refusing: tensor {name} is {ti.type_name} (block-quantized)")
            return 1
    w = GGUFWriter(args.out, arch=r.kv.get("general.architecture", "qwen3vl"))
    _copy_kv(w, r.kv)
    for name, ti in r.tensors.items():
        data = r.tensor(name, dtype=np.float32)
        w.add_tensor(name, data.byteswap(), ti.ggml_type)
    w.write()
    print(f"wrote {args.out} with byte-swapped tensor payloads")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="qwen3_asr_gguf_tpu_torch.formats")
    sub = p.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("dump")
    d.add_argument("path")
    d.add_argument("--tensors", action="store_true")
    d.add_argument("--kv", action="store_true")
    q = sub.add_parser("requant")
    q.add_argument("path")
    q.add_argument("out")
    q.add_argument("--quant", default="q4_k", choices=["q4_k", "q8_0", "q6_k", "f16"])
    h = sub.add_parser("hash")
    h.add_argument("path")
    h.add_argument("--no-tensors", action="store_true", help="overall hash only")
    sm = sub.add_parser("set-metadata")
    sm.add_argument("path")
    sm.add_argument("out")
    sm.add_argument("--set", action="append", required=True, metavar="KEY=VALUE")
    nm = sub.add_parser("new-metadata")
    nm.add_argument("path")
    nm.add_argument("out")
    nm.add_argument("--set", action="append", metavar="KEY=VALUE")
    nm.add_argument("--remove", action="append", metavar="KEY")
    nm.add_argument("--chat-template", help="file whose contents become tokenizer.chat_template")
    e = sub.add_parser("endian")
    e.add_argument("path")
    e.add_argument("out", nargs="?")
    e.add_argument("--to", choices=["big", "little"], default="big")
    args = p.parse_args(argv)
    return {
        "dump": cmd_dump,
        "requant": cmd_requant,
        "hash": cmd_hash,
        "set-metadata": cmd_set_metadata,
        "new-metadata": cmd_new_metadata,
        "endian": cmd_endian,
    }[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
