"""Interactive CLI REPL (port of visualcla_tpu/apps/inference.py, the
reference's scripts/inference/inference.py).

Same flags and REPL protocol: commands ``exit``, ``clear``,
``change image:<path>`` and ``add image:<path>`` (attach another image to the
next message).  ``--stream`` streams the answer, ``--speculative`` decodes
with prompt-lookup speculative decoding, ``--load_in_8bit`` /
``--load_in_4bit`` pick the text tower's weight tier.  It runs on the GPU;
``--only_cpu`` runs on the CPU instead.  ``--stream_chunk`` is the number of
tokens decoded between host reads while streaming; ``--gpus`` is accepted for
the JAX package's flags and changes nothing.  ``--visualcla_model`` is a
native checkpoint or a reference merged dir; unmerged checkpoints
(``--text_model`` + ``--vision_model`` + ``--lora_model``, comma-separated
LoRAs applied in order) are folded at load.

    python -m visualcla_tpu_torch.apps.inference --visualcla_model CKPT [--only_cpu]
    python -m visualcla_tpu_torch.apps.inference --text_model LLAMA --vision_model CLIP \
        --lora_model LORA [--only_cpu]
"""
from __future__ import annotations

import argparse
import logging

import numpy as np

logger = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--text_model", default=None, type=str,
                   help="Path to the pre-trained text encoder")
    p.add_argument("--vision_model", default=None, type=str,
                   help="Path to the pre-trained image encoder")
    p.add_argument("--lora_model", default=None, type=str,
                   help="Path to the VisualCLA LoRA model")
    p.add_argument("--visualcla_model", default=None, type=str,
                   help="Path to the merged/native VisualCLA model")
    p.add_argument("--image_file", default=None, type=str, help="The input image file")
    p.add_argument("--gpus", default="0", type=str,
                   help="accepted for the reference's flags; the current CUDA device is used")
    p.add_argument("--load_in_8bit", action="store_true", help="int8-quantize the LLM weights")
    p.add_argument("--load_in_4bit", action="store_true",
                   help="group-wise int4-quantize the LLM weights")
    p.add_argument("--only_cpu", action="store_true", help="run on the CPU")
    p.add_argument("--seed", default=-1, type=int, help="sampling seed")
    p.add_argument("--stream", action="store_true", help="stream tokens as they decode")
    p.add_argument("--speculative", action="store_true",
                   help="prompt-lookup speculative decoding (token-identical for greedy, "
                        "identical distribution for sampled configs)")
    p.add_argument("--stream_chunk", type=int, default=8,
                   help="tokens decoded between host reads while streaming (display "
                        "stays per-token)")
    return p


USAGE = f"""
{'='*10} Usage {'='*10}

Start Inference with instruction mode.
You can enter instruction or special control commands after '>'. Below are the usage of the control commands

change image:[image_path]\tload the image from [image_path]
add image:[image_path]\t\tATTACH another image to your NEXT message (multi-image turn; repeatable)
clear\t\t\t\tClear chat history. This command will not change the image.
exit\t\t\t\tExit Inference
"""


def main(argv=None):
    args = build_parser().parse_args(argv)
    logging.basicConfig(format="%(asctime)s - %(levelname)s - %(name)s - %(message)s",
                        level=logging.INFO)

    import visualcla_tpu_torch as visualcla
    from visualcla_tpu_torch.api import chat, chat_in_stream

    model, tokenizer, processor = visualcla.get_model_and_tokenizer_and_processor(
        visualcla_model=args.visualcla_model,
        text_model=args.text_model,
        vision_model=args.vision_model,
        lora_model=args.lora_model,
        load_in_8bit=args.load_in_8bit and (args.visualcla_model is not None),
        load_in_4bit=args.load_in_4bit and (args.visualcla_model is not None),
        device="cpu" if args.only_cpu else None,
    )

    logger.info("*** Start Inference ***")
    print(USAGE)
    seed = args.seed if args.seed != -1 else 0
    history = []
    pending_images = []  # images queued by `add image:` for the next turn
    image_path = args.image_file
    if image_path is not None:
        print(f"Image: {image_path}")
    while True:
        try:
            text = input(">")
        except EOFError:
            break
        if text == "exit":
            break
        if text == "clear":
            history = []
            print("Conversation history cleared.")
            continue
        if text.startswith("change image:"):
            image_path = text.split("change image:")[-1].strip()
            history = []
            pending_images = []
            continue
        if text.startswith("add image:"):
            pending_images.append(text.split("add image:")[-1].strip())
            print(f"{len(pending_images)} image(s) attached to your next message.")
            continue
        if pending_images:
            # a list opts into per-turn image markers (api._prepare_inputs);
            # the conversation image rides the first turn only
            turn_image = list(pending_images)
            if not history and image_path is not None:
                turn_image = [image_path] + turn_image
            elif history and image_path is not None:
                # single-image turns replayed in history carry a marker but no
                # stored pixels: backfill the conversation image
                first = history[0]
                if "first_instruction" in first and not first.get("images_pv"):
                    first["images"] = 1
                    first["images_pv"] = [np.asarray(
                        model.image_processor(image_path)["pixel_values"])]
        else:
            turn_image = image_path
        try:
            if args.stream:
                printed = 0
                for response, history in chat_in_stream(
                        model, image=turn_image, text=text, history=history, verbose=False,
                        seed=seed, chunk_size=args.stream_chunk,
                        speculative=args.speculative):
                    print(response[printed:], end="", flush=True)
                    printed = len(response)
                print()
            else:
                response, history = chat(model, image=turn_image, text=text, history=history,
                                         seed=seed, speculative=args.speculative)
            pending_images = []
        except FileNotFoundError:
            print(f"Cannot find file {image_path}. Clear history")
            history = []
            pending_images = []

    logger.info("*** Exit Inference ***")


if __name__ == "__main__":
    main()
