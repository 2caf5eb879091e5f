"""Training: precision plan, optimizer and schedules, the Trainer."""
