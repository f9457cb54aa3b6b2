"""Training: the AdamW optimizer with an fp32 master copy, the learning-rate
schedules, and the train step."""
