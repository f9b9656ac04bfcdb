from . import witch_runner

if __name__ == "__main__":
    witch_runner()
