"""text-generation-webui multimodal pipeline ``visualcla-7b-torch``."""
