"""Semver bump of the port's version: ``scripts/versionate`` on the port.

    python3 -m gymca_torch.versionate [--patch | --minor | --major] [--dry-run] [--root DIR]

Reads ``VERSION = "X.Y.Z"`` from ``<root>/gymca_torch/version.py`` (the
root is the checkout holding this package unless ``--root`` names another),
prints ``old -> new`` and, unless ``--dry-run``, writes the new version
there.  It writes that one file only: ``gymca_tpu/version.py`` and
``pyproject.toml`` (whose version attribute names ``gymca_tpu``) belong to
the JAX package, which ``scripts/versionate`` bumps.
"""

from __future__ import annotations

import argparse
import re
from pathlib import Path

__all__ = ["ROOT", "version_file", "current_version", "bump", "main"]

ROOT = Path(__file__).resolve().parent.parent
_VERSION = re.compile(r'VERSION\s*=\s*"(\d+)\.(\d+)\.(\d+)"')


def version_file(root: Path) -> Path:
    return Path(root) / "gymca_torch" / "version.py"


def current_version(path: Path) -> str:
    m = _VERSION.search(path.read_text())
    if not m:
        raise SystemExit(f"no VERSION found in {path}")
    return ".".join(m.groups())


def bump(version: str, part: str) -> str:
    major, minor, patch = map(int, version.split("."))
    if part == "major":
        return f"{major + 1}.0.0"
    if part == "minor":
        return f"{major}.{minor + 1}.0"
    return f"{major}.{minor}.{patch + 1}"


def main(argv=None) -> str:
    """Bumps the version; returns the new one."""
    parser = argparse.ArgumentParser(description="Semver bump of gymca_torch's version")
    group = parser.add_mutually_exclusive_group()
    group.add_argument("--patch", action="store_true")
    group.add_argument("--minor", action="store_true")
    group.add_argument("--major", action="store_true")
    parser.add_argument("--dry-run", action="store_true")
    parser.add_argument("--root", type=Path, default=ROOT,
                        help="the checkout whose gymca_torch/version.py to bump")
    args = parser.parse_args(argv)

    part = "major" if args.major else "minor" if args.minor else "patch"
    path = version_file(args.root)
    old = current_version(path)
    new = bump(old, part)
    print(f"{old} -> {new}")
    if not args.dry_run:
        text = path.read_text()
        updated = _VERSION.sub(f'VERSION = "{new}"', text, count=1)
        if updated != text:
            path.write_text(updated)
            print(f"updated {path}")
    return new


if __name__ == "__main__":
    main()
