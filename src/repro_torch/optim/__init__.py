"""Optimizer substrate of the port: AdamW (+ int8 moments), the LR
schedule, gradient compression."""
