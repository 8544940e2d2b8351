"""Turn a CUDA source into C++ for the emulator in this directory:
``kernel<<<g, b, s, st>>>(args)`` becomes ``emu_launch(kernel, g, b, s, st, args)``
and the ``extern __shared__`` declaration goes (the emulator's ``sm`` takes its
place). Usage: ``python emu.py source.cu out.cpp``."""

import sys


def translate(src: str) -> str:
    out = []
    i = 0
    while True:
        j = src.find("<<<", i)
        if j < 0:
            out.append(src[i:])
            break
        k = j  # the kernel's name starts before its template arguments, if any
        if src[k - 1] == ">":
            depth = 0
            while True:
                k -= 1
                if src[k] == ">":
                    depth += 1
                elif src[k] == "<":
                    depth -= 1
                    if depth == 0:
                        break
        while k > 0 and (src[k - 1].isalnum() or src[k - 1] in "_:"):
            k -= 1
        end = src.index(">>>", j)
        if src[end + 3] != "(":
            raise ValueError(f"a launch without arguments at {src[k:end + 10]!r}")
        out.append(src[i:k])
        out.append(f"emu_launch({src[k:j]}, {src[j + 3:end]}, ")
        i = end + 4
    return "".join(out).replace("extern __shared__ float sm[];", "")


if __name__ == "__main__":
    with open(sys.argv[1]) as f, open(sys.argv[2], "w") as g:
        g.write(translate(f.read()))
