"""Gradio web demo (port of visualcla_tpu/apps/gradio_demo.py, the
reference's scripts/inference/gradio_demo.py).

The same UI: a chatbot pane, Upload / Webcam image tabs, sliders
(max_new_tokens 0-1024 default 512, top_p .9, top_k 40, temperature .5),
streamed or blocking replies, markdown and code-block rendering, reset and
clear, port 8090.  It runs on the GPU; ``--only_cpu`` runs on the CPU.
``--gpus`` is accepted for the reference's flags and changes nothing.
Gradio is optional: it is imported when the UI is built, and without it
``main`` exits with a message naming the REPL and the HTTP server.  The
callback the UI wires (``make_predict``) needs no gradio.

    python -m visualcla_tpu_torch.apps.gradio_demo --visualcla_model CKPT [--only_cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import html
import re


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--visualcla_model", default=None, type=str, required=True,
                   help="Path to the merged/native VisualCLA model")
    p.add_argument("--gpus", default="0", type=str, help="compat no-op")
    p.add_argument("--share", default=False, action="store_true",
                   help="share gradio domain name")
    p.add_argument("--load_in_8bit", action="store_true")
    p.add_argument("--load_in_4bit", action="store_true")
    p.add_argument("--only_cpu", action="store_true")
    p.add_argument("--no_stream", action="store_true",
                   help="Output without stream mode.")
    p.add_argument("--port", type=int, default=8090)
    return p


# The reference post-processes the chat through mdtex2html (markdown plus
# LaTeX to MathML).  Here the markdown pass (tables, fenced code, line
# breaks) runs on the server through the `markdown` package and LaTeX spans
# are kept verbatim for gradio's client-side math renderer
# (gr.Chatbot(latex_delimiters=...)).
_LATEX_TOKEN = re.compile("\x00LATEX(\\d+)\x00")
LATEX_DELIMITERS = [
    {"left": "$$", "right": "$$", "display": True},
    {"left": "$", "right": "$", "display": False},
]
EMPTY_IMAGE = "图片不能为空。请重新上传图片。"


def convert_markdown(text: str) -> str:
    """Render a model response: markdown (tables, fenced code, newlines) to
    HTML with ``$...$`` / ``$$...$$`` LaTeX spans protected from the markdown
    pass (underscores inside math would otherwise become <em>)."""
    import markdown as md

    spans = []

    def _stash(m, display):
        spans.append((m.group(1), display))
        return f"\x00LATEX{len(spans) - 1}\x00"

    text = re.sub(r"\$\$(.+?)\$\$", lambda m: _stash(m, True), text,
                  flags=re.S)
    text = re.sub(r"\$([^$\n]+?)\$", lambda m: _stash(m, False), text)
    out = md.markdown(text, extensions=["tables", "fenced_code", "nl2br"])

    def _unstash(m):
        body, display = spans[int(m.group(1))]
        return f"$${body}$$" if display else f"${body}$"

    return _LATEX_TOKEN.sub(_unstash, out)


def parse_text(text: str) -> str:
    """Markdown-ish renderer: fenced code blocks -> <pre><code>, the rest
    HTML-escaped with <br> line breaks (the reference's parse_text)."""
    out = []
    in_code = False
    for i, line in enumerate(ln for ln in text.split("\n") if ln != ""):
        if "```" in line:
            if not in_code:
                lang = line.split("`")[-1]
                out.append(f'<pre><code class="language-{lang}">')
            else:
                out.append("<br></code></pre>")
            in_code = not in_code
        else:
            if i > 0 and not in_code:
                line = html.escape(line).replace(" ", "&nbsp;")
                out.append("<br>" + line)
            elif i > 0:
                out.append("<br>" + line)
            else:
                out.append(line)
    return "".join(out)


def make_predict(model, no_stream: bool = False):
    """The UI's submit callback over a loaded ``VisualCLA``: a generator
    with the JAX demo's ten arguments, yielding (chatbot, history) after
    each streamed token (once with ``no_stream``); the last chat entry is
    (``parse_text(text)``, ``convert_markdown(response)``).  Without an image it
    yields the reference's error message and runs nothing."""
    from ..api import DEFAULT_GENERATION_CONFIG, chat, chat_in_stream

    def predict(input_text, image_upload, image_webcam, chatbot,
                max_new_tokens, top_p, top_k, temperature, history, selected):
        image = image_upload if selected == "Upload" else image_webcam
        gc = dataclasses.replace(
            DEFAULT_GENERATION_CONFIG,
            max_new_tokens=int(max_new_tokens), top_p=float(top_p),
            top_k=int(top_k), temperature=float(temperature),
        )
        if image is None:
            yield [(input_text, EMPTY_IMAGE)], []
            return
        chatbot = chatbot + [(parse_text(input_text), "")]
        if no_stream:
            response, history = chat(model, image=image, text=input_text,
                                     history=history, generation_config=gc,
                                     verbose=False)
            chatbot[-1] = (parse_text(input_text), convert_markdown(response))
            yield chatbot, history
        else:
            for response, history in chat_in_stream(
                model, image=image, text=input_text, history=history,
                generation_config=gc, verbose=False,
            ):
                chatbot[-1] = (parse_text(input_text), convert_markdown(response))
                yield chatbot, history

    return predict


def main(argv=None):
    args = build_parser().parse_args(argv)
    try:
        import gradio as gr
    except ImportError as e:
        raise SystemExit(
            "gradio is not installed in this environment; "
            "`pip install gradio` to use the web demo "
            "(the CLI REPL `python -m visualcla_tpu_torch.apps.inference` and the "
            "HTTP server `python -m visualcla_tpu_torch.apps.serve` have no extra deps)."
        ) from e

    import visualcla_tpu_torch as visualcla

    print("Loading the model...")
    model, tokenizer, _ = visualcla.get_model_and_tokenizer_and_processor(
        visualcla_model=args.visualcla_model,
        load_in_8bit=args.load_in_8bit and (args.visualcla_model is not None),
        load_in_4bit=args.load_in_4bit and (args.visualcla_model is not None),
        device="cpu" if args.only_cpu else None,
    )
    predict = make_predict(model, no_stream=args.no_stream)

    with gr.Blocks() as demo:
        selected_state = gr.State("Upload")

        def on_select(evt: gr.SelectData):
            return evt.value

        gr.HTML('<p align="center"><b>VisualCLA (PyTorch)</b></p>')
        with gr.Row():
            with gr.Column(scale=4):
                try:
                    chatbot = gr.Chatbot(height=400,
                                         latex_delimiters=LATEX_DELIMITERS)
                except TypeError:  # older gradio without latex_delimiters
                    chatbot = gr.Chatbot(height=400)
                user_input = gr.Textbox(show_label=False,
                                        placeholder="Your Instruction here", lines=4)
                with gr.Row():
                    submit_btn = gr.Button("提交", variant="primary")
                    empty_btn = gr.Button("清除")
            with gr.Column(scale=3):
                with gr.Tab("Upload") as t1:
                    image_upload = gr.Image(type="pil", label="Image", value=None)
                    t1.select(on_select, outputs=selected_state)
                with gr.Tab("Webcam") as t2:
                    image_webcam = gr.Image(type="pil", label="Image", value=None,
                                            sources=["webcam"])
                    t2.select(on_select, outputs=selected_state)
                max_new_tokens = gr.Slider(0, 1024, value=512, step=1.0,
                                           label="Max new tokens", interactive=True)
                top_p = gr.Slider(0, 1, value=0.9, step=0.01, label="Top P",
                                  interactive=True)
                top_k = gr.Slider(0, 100, value=40, step=1, label="Top K",
                                  interactive=True)
                temperature = gr.Slider(0, 1, value=0.5, step=0.01,
                                        label="Temperature", interactive=True)

        history = gr.State([])
        submit_btn.click(
            predict,
            [user_input, image_upload, image_webcam, chatbot,
             max_new_tokens, top_p, top_k, temperature, history, selected_state],
            [chatbot, history], show_progress=True,
        )
        submit_btn.click(lambda: gr.update(value=""), [], [user_input])
        empty_btn.click(lambda: (None, None, [], []),
                        outputs=[image_upload, image_webcam, chatbot, history],
                        show_progress=True)

    demo.queue().launch(share=args.share, server_name="0.0.0.0",
                        server_port=args.port)


if __name__ == "__main__":
    main()
