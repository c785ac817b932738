"""The text-generation-webui multimodal plugin (``visualcla_torch_pipeline/``);
its webui settings are the JAX plugin's, in the repository's
``integrations/text_generation_webui/settings/``."""
