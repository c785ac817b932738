"""Install script for visualcla_tpu.

TPU-native (JAX/XLA/Pallas) framework with the capabilities of
airaria/Visual-Chinese-LLaMA-Alpaca (reference: /root/reference/setup.py:7-29).
"""
from setuptools import setup, find_packages

setup(
    name="visualcla_tpu",
    version="0.1.0",
    description="TPU-native multimodal Chinese chat framework (CLIP-ViT + visual resampler + LLaMA)",
    license="Apache-2.0",
    license_files=["LICENSE", "NOTICE"],
    packages=find_packages(include=["visualcla_tpu", "visualcla_tpu.*",
                                    "visualcla_tpu_torch", "visualcla_tpu_torch.*"]),
    package_data={"visualcla_tpu": ["configs/*.json"],
                  "visualcla_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "numpy",
        "safetensors",
        "optax",
    ],
    extras_require={
        "convert": ["torch"],
        "images": ["Pillow"],
        "demo": ["gradio"],
        "test": ["pytest", "torch", "transformers", "Pillow", "tokenizers"],
    },
    entry_points={
        "console_scripts": [
            "visualcla-chat=visualcla_tpu.apps.inference:main",
            "visualcla-serve=visualcla_tpu.apps.serve:main",
            "visualcla-evaluate=visualcla_tpu.apps.evaluate:main",
            "visualcla-convert=visualcla_tpu.checkpoint.convert:main",
            "visualcla-train=visualcla_tpu.train.run_training:main",
            "visualcla-parity=visualcla_tpu.apps.parity_check:main",
            "visualcla-split-adapter=visualcla_tpu.checkpoint.split_adapter:main",
        ]
    },
)
