"""Experiment provenance: archive the working tree into the output dir (a
copy of `ccdm_tpu/utils/archive.py`).

Parity: `archive_code` (`ddpm/utils.py:40-43`) — `git ls-files | tar czf
code.tar.gz` plus a copy of the params file.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tarfile


def archive_code(output_path: str, params_file: str | None = None) -> None:
    os.makedirs(output_path, exist_ok=True)
    try:
        files = subprocess.run(
            ["git", "ls-files"], capture_output=True, text=True, check=True,
        ).stdout.splitlines()
    except (subprocess.CalledProcessError, FileNotFoundError):
        files = []
    if files:
        with tarfile.open(os.path.join(output_path, "code.tar.gz"), "w:gz") as tar:
            for f in files:
                if os.path.exists(f):
                    tar.add(f)
    if params_file and os.path.exists(params_file):
        shutil.copy(params_file, os.path.join(output_path, os.path.basename(params_file)))
