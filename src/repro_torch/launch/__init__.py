"""Entry points: the single-device training launcher."""
