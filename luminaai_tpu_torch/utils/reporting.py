"""Data and training reports (port of luminaai_tpu/utils/reporting.py).

Two entry points, as in the JAX module: a dataset analysis report over
jsonl conversation files and a post-run training report over an experiment
directory, each a self-contained HTML page built from the port's own
validation (`data/processing.validate_data_comprehensive`) and metrics
formats (the `monitoring/logger` jsonl, the trainer's summary json). The
pages are the JAX module's, byte for byte but the "Generated on" line.
"""

from __future__ import annotations

import json
import logging
import os
from datetime import datetime
from pathlib import Path
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

_PAGE_STYLE = """
body { font-family: sans-serif; margin: 20px; }
.section { margin: 20px 0; padding: 15px; border: 1px solid #ddd; border-radius: 5px; }
.metric { display: inline-block; margin: 8px; padding: 8px 12px; background: #f5f5f5; border-radius: 3px; }
.error { color: #b00; }
table { border-collapse: collapse; width: 100%; }
th, td { border: 1px solid #ddd; padding: 6px 8px; text-align: left; }
th { background: #f2f2f2; }
"""


def _page(title: str, body: str) -> str:
    now = datetime.now().strftime("%Y-%m-%d %H:%M:%S")
    return (
        f"<!DOCTYPE html><html><head><title>{title}</title>"
        f"<style>{_PAGE_STYLE}</style></head><body>"
        f"<h1>{title}</h1><p>Generated on: {now}</p>{body}</body></html>"
    )


def _metric(label: str, value: Any) -> str:
    return f'<div class="metric">{label}: {value}</div>'


def create_data_summary_report(
    data_paths: List[str],
    tokenizer,
    output_path: str = "data_summary_report.html",
) -> str:
    """Dataset analysis report.

    Runs validate_data_comprehensive per file; renders file info, conversation
    stats, token stats, role distribution, and sample quality issues.
    """
    from luminaai_tpu_torch.data.processing import validate_data_comprehensive

    sections = []
    for data_path in data_paths:
        logger.info("Analyzing %s...", data_path)
        stats = validate_data_comprehensive(data_path, tokenizer)
        tok = stats.get("token_stats", {})
        issues = stats.get("issues", {})
        checked = stats.get("checked", 0)
        valid = stats.get("valid", 0)

        try:
            st = os.stat(data_path)
            size_mb = st.st_size / 1e6
            modified = datetime.fromtimestamp(st.st_mtime).strftime(
                "%Y-%m-%d %H:%M:%S"
            )
        except OSError:
            size_mb, modified = 0.0, "Unknown"

        issue_rows = "".join(
            f"<tr><td>{kind}</td><td>{count:,}</td></tr>"
            for kind, count in sorted(issues.items())
        )
        issue_list = "".join(
            f'<li class="error">{kind}: {count}</li>'
            for kind, count in issues.items()
            if count
        )
        sections.append(
            f'<div class="section"><h2>Dataset: {os.path.basename(data_path)}</h2>'
            "<h3>File Information</h3>"
            + _metric("Size", f"{size_mb:.1f} MB")
            + _metric("Modified", modified)
            + "<h3>Conversation Statistics</h3>"
            + _metric("Checked", f"{checked:,}")
            + _metric("Valid Conversations", f"{valid:,}")
            + _metric(
                "Success Rate", f"{valid / checked:.2%}" if checked else "n/a"
            )
            + "<h3>Token Statistics</h3>"
            + _metric("Avg Tokens", f"{tok.get('mean', 0):.1f}")
            + _metric("P95 Tokens", f"{tok.get('p95', 0):,.0f}")
            + _metric("Max Tokens", f"{tok.get('max', 0):,}")
            + "<h3>Issue Breakdown</h3>"
            f"<table><tr><th>Issue</th><th>Count</th></tr>{issue_rows}</table>"
            f"<h3>Problems Found</h3><ul>{issue_list or '<li>none</li>'}</ul></div>"
        )

    html = _page("Dataset Analysis Report", "".join(sections))
    with open(output_path, "w") as f:
        f.write(html)
    logger.info("Data summary report saved: %s", output_path)
    return str(output_path)


def create_training_report(
    experiment_path: str, output_path: Optional[str] = None
) -> Optional[str]:
    """Post-run training report.

    Reads `training_summary.json` (written by the trainer/CLI) and the
    metrics jsonl; renders run summary, key config, health, and final
    metric values.
    """
    experiment_dir = Path(experiment_path)
    if output_path is None:
        output_path = experiment_dir / "training_report.html"

    summary_file = experiment_dir / "training_summary.json"
    if not summary_file.exists():
        logger.error("Training summary not found: %s", summary_file)
        return None
    summary = json.loads(summary_file.read_text())

    metrics: List[Dict[str, Any]] = []
    for candidate in (
        experiment_dir / "metrics.jsonl",
        experiment_dir / "logs" / "metrics.jsonl",
    ):
        if candidate.exists():
            with open(candidate) as f:
                metrics = [json.loads(line) for line in f if line.strip()]
            break

    body = ['<div class="section"><h3>Training Summary</h3>']
    for label, key, fmt in (
        ("Total Time", "total_training_time_hours", "{:.2f} h"),
        ("Total Epochs", "total_epochs", "{}"),
        ("Total Steps", "total_steps", "{}"),
        ("Best Eval Loss", "best_eval_loss", "{:.6f}"),
        ("Final Train Loss", "final_train_loss", "{:.6f}"),
    ):
        value = summary.get(key, summary.get("final_metrics", {}).get(key))
        if value is not None:
            body.append(_metric(label, fmt.format(value)))
    body.append("</div>")

    config = summary.get("model_config", summary.get("config", {}))
    if config:
        rows = "".join(
            f"<tr><td>{k}</td><td>{config[k]}</td></tr>"
            for k in (
                "hidden_size", "num_layers", "num_heads", "seq_length",
                "batch_size", "learning_rate", "num_epochs", "precision",
                "use_moe", "num_experts",
            )
            if k in config
        )
        body.append(
            '<div class="section"><h3>Model Configuration</h3>'
            f"<table><tr><th>Parameter</th><th>Value</th></tr>{rows}</table></div>"
        )

    health = summary.get("health_summary", {})
    if health:
        body.append(
            '<div class="section"><h3>Health Summary</h3>'
            + _metric("Status", health.get("status", "Unknown"))
            + _metric("Health Score", f"{health.get('health_score', 0):.2f}")
            + _metric("Alerts", health.get("total_alerts", 0))
            + "</div>"
        )

    if metrics:
        last = metrics[-1]
        rows = "".join(
            f"<tr><td>{k}</td><td>{v}</td></tr>"
            for k, v in sorted(last.items())
            if isinstance(v, (int, float))
        )
        body.append(
            f'<div class="section"><h3>Final Metrics (step {last.get("step", "?")},'
            f" {len(metrics)} records)</h3>"
            f"<table><tr><th>Metric</th><th>Value</th></tr>{rows}</table></div>"
        )

    html = _page(
        f"Training Report - {summary.get('experiment_name', experiment_dir.name)}",
        "".join(body),
    )
    with open(output_path, "w") as f:
        f.write(html)
    logger.info("Training report saved: %s", output_path)
    return str(output_path)
