"""The assigned architectures, in the JAX package's order (port of
``repro.configs.all_configs``): the dry run's ``--all`` walks each of
them over every input shape. The registry loads every config on first
use (``get_config``), so this module holds only the list."""

ASSIGNED = [
    "whisper-tiny",
    "starcoder2-3b",
    "jamba-1.5-large-398b",
    "mamba2-2.7b",
    "llama4-scout-17b-a16e",
    "qwen1.5-0.5b",
    "deepseek-v2-236b",
    "qwen2.5-3b",
    "llama-3.2-vision-11b",
    "qwen1.5-32b",
]
