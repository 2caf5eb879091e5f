"""Child-subprocess runner shared by the port's bench harnesses.

bench_torch.py and bench_ops_torch.py run every measurement in a child
process with a timeout (a wedged card or a hung kernel must cost one
rung, not the harness) and recover exactly one validated JSON payload
from the child's stdout. One implementation, so the two cannot drift.
"""

from __future__ import annotations

import json
import subprocess
from typing import Callable, Dict, List, Optional, Tuple


def run_child(
    cmd: List[str],
    timeout: int,
    validate: Callable[[Dict], bool],
    label: str,
    env: Optional[Dict[str, str]] = None,
    cwd: Optional[str] = None,
) -> Tuple[Optional[Dict], str]:
    """Run cmd; return (payload | None, diagnostic).

    The payload is the LAST stdout line that parses as a JSON object and
    passes `validate`: stray JSON-looking log lines are skipped.
    """
    try:
        proc = subprocess.run(
            cmd, capture_output=True, text=True, timeout=timeout,
            env=env, cwd=cwd,
        )
    except subprocess.TimeoutExpired:
        return None, f"{label}: timeout after {timeout}s"
    for line in reversed(proc.stdout.strip().splitlines()):
        line = line.strip()
        if not line.startswith("{"):
            continue
        try:
            parsed = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(parsed, dict) and validate(parsed):
            return parsed, f"{label}: ok"
    return None, f"{label}: rc={proc.returncode} stderr={proc.stderr[-500:]!r}"
