"""Checkpoint hashing: SHA-256 + legacy AutoV1 model hash, Civitai lookup.

CLI form of the reference's Tk hasher (reference scripts/
"anima hash checker.py":24-101): full-file SHA-256 (uppercase, the Civitai
AutoV2 source), the legacy A1111 "model hash" (SHA-256 of bytes
0x100000..0x110000, first 8 hex chars), and an optional Civitai by-hash API
lookup (requires network; zero-egress environments just get the hashes).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os

CHUNK_SIZE = 1024 * 1024


def sha256_file(path, progress_cb=None) -> str:
    h = hashlib.sha256()
    total = os.path.getsize(path)
    done = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(CHUNK_SIZE)
            if not chunk:
                break
            h.update(chunk)
            done += len(chunk)
            if progress_cb:
                progress_cb(done, total)
    return h.hexdigest().upper()


def model_hash_legacy(path) -> str:
    """A1111-style hash: SHA-256 of bytes 0x100000..0x110000, first 8 hex."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        f.seek(0x100000)
        h.update(f.read(0x10000))
    return h.hexdigest()[:8].upper()


def autov2(sha256_hex: str) -> str:
    return sha256_hex[:10].upper()


def civitai_lookup(sha256_hex: str, token: str | None = None,
                   timeout: float = 10.0) -> dict | None:
    """Look the hash up on Civitai's by-hash API (None if unreachable)."""
    import urllib.request
    url = f"https://civitai.com/api/v1/model-versions/by-hash/{sha256_hex}"
    headers = {"User-Agent": "aozora-tpu-hash-checker"}
    if token:
        headers["Authorization"] = f"Bearer {token.strip()}"
    try:
        req = urllib.request.Request(url, headers=headers)
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return json.loads(resp.read().decode("utf-8"))
    except Exception as e:  # noqa: BLE001 — offline/404 both mean "no info"
        print(f"INFO: Civitai lookup unavailable: {e}")
        return None


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Hash a model checkpoint.")
    parser.add_argument("path")
    parser.add_argument("--civitai", action="store_true",
                        help="look the hash up on Civitai")
    parser.add_argument("--token", default=None)
    args = parser.parse_args(argv)
    sha = sha256_file(args.path)
    out = {
        "sha256": sha,
        "autov2": autov2(sha),
        "legacy_model_hash": model_hash_legacy(args.path),
    }
    if args.civitai:
        info = civitai_lookup(sha, args.token)
        if info:
            out["civitai"] = {"name": info.get("name"),
                              "model": info.get("model", {}).get("name")}
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
