"""How unevenly the router spread the window's tokens over the experts: in
each MoE layer the assignments of its busiest expert over the mean of its
experts' (``counts["moe_expert_tokens"]`` as it moved over the window), summed
over the layers; 1 a layer where every expert got as many.  The busiest
expert bounds a layer's B7 launch at admissions, where the tiles of the
other experts finish first."""


def read(record):
    c0, c1 = record["c0"]["counts"], record["c1"]["counts"]
    if "moe_expert_tokens" not in c1:
        return None
    E = record["cfg"]["num_experts"]
    d = [b - a for a, b in zip(c0["moe_expert_tokens"], c1["moe_expert_tokens"])]
    total = 0.0
    for layer in range(len(d) // E):
        row = d[layer * E:(layer + 1) * E]
        if sum(row):
            total += max(row) / (sum(row) / E)
    return total or None
