"""Frame fine-tuning: criteria, optimizer, train step and epoch engine."""
